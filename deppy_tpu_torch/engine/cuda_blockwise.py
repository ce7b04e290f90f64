"""Blockwise BCP fixpoint: CUDA kernel wrapper and plain version (port of ``deppy_tpu/engine/pallas_blockwise.py:67-190``).

:func:`bcp_fixpoint` runs the propagation to a fixpoint for a batch of
problems as Gauss-Seidel sweeps over blocks ("tiles") of clause rows: each
tile runs its local fixpoint, t/f carry from tile to tile, the AtMost rows
ride tile 0, and sweeps repeat until one changes nothing.  A CUDA tensor
goes to the hand-written kernel ``csrc/blockwise.cu`` (one thread block
per problem, the sweep a loop inside the block over shared-memory tiles);
a CPU tensor goes to :func:`bcp_fixpoint_plain`
(``core._fixpoint_blockwise_u`` one problem at a time).  Like the Pallas
kernel it has no entry-overlap check; its caller adds it.

Tile height: ``min(block_rows, C, rows that fit)``.  A row of pos and neg
words costs ``8 * W`` bytes of shared memory, and a block may hold
:data:`SMEM_BYTES` less the fixpoint's working words (``csrc/fixpoint.cuh``
``work_words``), the phase kernels' extra planes and their control
structs.  :func:`tile_rows` computes it the same way for the kernel and
the plain version, so both run the same blocks.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from . import _build, core
from .cuda_bcp import _check_args

# Clause rows per block (pallas_blockwise.py:64).
BLOCK_ROWS = int(os.environ.get("DEPPY_GPU_BLOCK_ROWS", "2048"))

# The opt-in shared memory of one thread block on the H100.
SMEM_BYTES = 232448
# Words kept free for the kernels' static shared control structs.
STATIC_WORDS = 64

THREADS = 256

# Kernel launches since the count was last reset (one per launch).
launches = 0


def _work_words(W: int, NA: int) -> int:
    """``work_words`` of ``csrc/fixpoint.cuh``."""
    return 4 * W + NA + 4


def tile_offset_words(W: int, NA: int) -> int:
    """Shared words ahead of the tile (``csrc/blockwise.cuh``): the
    fixpoint's working words and five extra planes, 16-byte aligned."""
    return (_work_words(W, NA) + 5 * W + 3) & ~3


def tile_rows(block_rows: int, C: int, W: int, NA: int) -> int:
    """Rows per tile: ``min(block_rows, C, rows that fit)``."""
    free = SMEM_BYTES // 4 - STATIC_WORDS - tile_offset_words(W, NA)
    fit = free // (2 * W)
    if fit < 1:
        raise ValueError(f"one clause row of {W} words does not fit the "
                         f"{SMEM_BYTES}-byte shared memory of a block "
                         f"beside {NA} AtMost rows")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    return min(block_rows, C, fit)


def bcp_fixpoint(pos, neg, mem, card_active, card_n, min_bits, min_w, t0,
                 f0, en, block_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched blockwise fixpoint.  int32 inputs as
    :func:`cuda_bcp.bcp_fixpoint`: pos/neg [B, C, W], mem [B, NA, W],
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
    tile = tile_rows(block_rows, C, W, NA)
    if dev.type == "cpu":
        return bcp_fixpoint_plain(**args, block_rows=tile)
    lib = _build.load()
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    t = torch.empty((B, W), dtype=torch.int32, device=dev)
    f = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.deppy_blockwise_fixpoint(
        pos.data_ptr(), neg.data_ptr(), mem.data_ptr(),
        card_active.data_ptr(), card_n.data_ptr(), min_bits.data_ptr(),
        min_w.data_ptr(), t0.data_ptr(), f0.data_ptr(), en.data_ptr(),
        conflict.data_ptr(), t.data_ptr(), f.data_ptr(), B, C, NA, W, tile,
        THREADS, stream)
    launches += 1
    _build.check(rc, "blockwise_fixpoint")
    return conflict, t, f


def bcp_fixpoint_plain(pos, neg, mem, card_active, card_n, min_bits, min_w,
                       t0, f0, en, block_rows: int):
    """The plain version of :func:`bcp_fixpoint`, on any device, with
    blocks of ``min(block_rows, C)`` rows."""
    B, W = t0.shape
    conflict = torch.zeros(B, dtype=torch.int32, device=t0.device)
    t = t0.clone()
    f = f0.clone()
    for b in range(B):
        S = core._Space(core._to_u(pos[b]), core._to_u(neg[b]),
                        core._to_u(mem[b]), card_n[b].to(torch.int64),
                        card_active[b] != 0, None)
        c, tb, fb = core._fixpoint_blockwise_u(
            S, core._to_u(t0[b]), core._to_u(f0[b]), core._to_u(min_bits[b]),
            int(min_w[b]), bool(en[b]), block_rows)
        conflict[b] = int(c)
        t[b] = core._to_i32(tb)
        f[b] = core._to_i32(fb)
    return conflict, t, f

