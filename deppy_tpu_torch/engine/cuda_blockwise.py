"""Blockwise BCP fixpoint: CUDA kernel wrapper and plain version (port of ``deppy_tpu/engine/pallas_blockwise.py:67-190``).

:func:`bcp_fixpoint` runs the propagation to a fixpoint for a batch of
problems as Gauss-Seidel sweeps over blocks ("tiles") of clause rows: each
tile runs its local fixpoint, t/f carry from tile to tile, the AtMost rows
ride tile 0, and sweeps repeat until one changes nothing.  A CUDA tensor
goes to the hand-written kernel ``csrc/blockwise.cu`` (one thread block
per problem, the sweep a loop inside the block over shared-memory tiles);
a CPU tensor goes to :func:`bcp_fixpoint_plain`
(``core._fixpoint_blockwise_u`` one problem at a time, on dense planes).
Like the Pallas kernel it has no entry-overlap check; its caller adds it.

Compact rows.  The kernel reads no dense plane: :func:`compact_rows`
turns ``ProblemTensors.clauses`` and ``card_ids`` into literal and member
lists on the device, once per launch (every distinct signed literal of a
row once, 0 after, in int16 where the planes hold fewer than 32,768
variables).  A repeated literal would count twice among a row's
unassigned literals where the dense planes merge it, so it is dropped; a
row holding both x and ~x keeps both, as the planes do.

Tile height: ``min(block_rows, C, rows whose compact literals fit)``
(:func:`tile_rows`), the same for the kernel and the plain version, so
both run the same blocks.  "Fit" is two tiles of ``K``-literal rows beside
the fixpoint's working words, the phase kernels' extra planes and the
AtMost lists in :data:`SMEM_BYTES`.  Where one tile holds every row the
kernel keeps them resident instead, staged once per launch
(:func:`resident`).

A solve builds its compact rows once (the driver) and hands them to every
launch through the wrappers' ``rows`` argument; a wrapper given none
builds them from ``clauses`` and ``card_ids``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, core, counts
from .cuda_bcp import _check_args
from .teams import SMEM_BYTES

# Clause rows per block (pallas_blockwise.py:64).
BLOCK_ROWS = int(os.environ.get("DEPPY_GPU_BLOCK_ROWS", "2048"))

# Words kept free for the kernels' static shared control structs.
STATIC_WORDS = 128

# Threads per block of the blockwise kernels, picked by chip_smoke.py's
# measurement on the H100 (PERF.md §6): 512 threads beat 256 by 1.4-1.6x
# and come within 15% of 1024 (faster on the 64-catalog batch, slower on
# the giant).
THREADS = 512

class Compact(NamedTuple):
    """Compact rows of a batch: ``lits`` [B, C, K] signed 1-based literals
    and ``mlits`` [B, NA, M] 1-based AtMost members, int16 or int32, each
    row's distinct entries first and 0 after.

    ``placement`` is where a launch keeps them: ``"auto"`` (every solve)
    keeps them resident in shared memory when one tile holds every row
    and streams the tiles otherwise.  That rule is chip_smoke.py's
    measurement on the H100 (PERF.md §6): resident rows beat streamed
    ones by 25% on one-tile problems and lose 3-7% on the giant's four
    tiles.  ``"resident"`` (wherever they fit) and ``"streamed"`` force
    one placement, for that measurement only."""

    lits: torch.Tensor
    mlits: torch.Tensor
    placement: str = "auto"

    @property
    def lit_bytes(self) -> int:
        return self.lits.element_size()

    def take(self, sel) -> "Compact":
        """The lanes ``sel`` (a slice or an index tensor)."""
        if isinstance(sel, slice):
            return self._replace(lits=self.lits[sel], mlits=self.mlits[sel])
        return self._replace(lits=self.lits.index_select(0, sel),
                             mlits=self.mlits.index_select(0, sel))


def lit_bytes(W: int) -> int:
    """Bytes of one compact literal over planes of ``W`` words."""
    return 2 if core.WORD * W < 1 << 15 else 4


def _width(n: int, lb: int) -> int:
    """A list width: int16 lists are padded to whole 32-bit words."""
    n = max(n, 1)
    return n + (n & 1) if lb == 2 else n


def _list_bytes(rows: int, width: int, lb: int) -> int:
    """``list_bytes`` of ``csrc/blockwise.cuh``."""
    return (rows * width * lb + 15) & ~15


def _work_words(W: int, NA: int) -> int:
    """``work_words`` of ``csrc/fixpoint.cuh``."""
    return 4 * W + NA + 9


def tile_offset_words(W: int, NA: int) -> int:
    """Shared words ahead of the compact rows (``csrc/fixpoint.cuh``):
    the fixpoint's working words and five extra planes, 16-byte aligned."""
    return (_work_words(W, NA) + 5 * W + 3) & ~3


def _fixed_bytes(W: int, NA: int, M: int, lb: int) -> int:
    """Shared bytes every blockwise launch holds: static structs, working
    words, extra planes and the AtMost lists."""
    return (4 * (STATIC_WORDS + tile_offset_words(W, NA))
            + _list_bytes(NA, _width(M, lb), lb))


def tile_rows(block_rows: int, C: int, K: int, M: int, W: int,
              NA: int) -> int:
    """Rows per tile: ``min(block_rows, C, rows whose compact literals
    fit)``, from the padded clause width ``K`` and AtMost width ``M``."""
    lb = lit_bytes(W)
    free = SMEM_BYTES - _fixed_bytes(W, NA, M, lb)
    fit = max(free // 2, 0) // 16 * 16 // (_width(K, lb) * lb)
    if fit < 1:
        raise ValueError(f"one clause row of {K} literals does not fit the "
                         f"{SMEM_BYTES}-byte shared memory of a block beside "
                         f"{NA} AtMost rows of {M} members over {W} words")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    return min(block_rows, C, fit)


def resident(rows: Compact, W: int, tile: int) -> bool:
    """Whether a launch keeps every compact row resident in shared
    memory (``rows.placement``)."""
    B, C, K = rows.lits.shape
    NA, M = rows.mlits.shape[1:]
    lb = rows.lit_bytes
    if rows.placement not in ("auto", "resident", "streamed"):
        raise ValueError(f"unknown placement {rows.placement!r}")
    if rows.placement == "streamed" or (rows.placement == "auto"
                                        and C > tile):
        return False
    return _fixed_bytes(W, NA, M, lb) + _list_bytes(C, K, lb) <= SMEM_BYTES


def _lists(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, R, K] int32 (0 = empty) → (the same rows with each distinct
    value once and 0 after, the longest row's length as a 0-d tensor)."""
    s = torch.sort(x, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    s = torch.where(dup, 0, s)
    order = torch.sort((s == 0).to(torch.int8), dim=-1, stable=True).indices
    s = torch.gather(s, -1, order)
    n = (s != 0).sum(-1)
    return s, (n.amax() if n.numel() else n.new_zeros(()))


def _cut(x: torch.Tensor, width: int, dtype) -> torch.Tensor:
    if width > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return x[..., :width].to(dtype).contiguous()


def compact_rows(clauses: torch.Tensor, card_ids: torch.Tensor, W: int,
                 n_vars: Optional[torch.Tensor] = None) -> Compact:
    """The kernel's compact rows, on the tensors' device: ``clauses``
    [B, C, K] (signed 1-based, 0 padded) and ``card_ids`` [B, NA, M]
    (0-based, -1 padded) over planes of ``W`` words.  Each row keeps its
    distinct entries, 0 after, cut to the batch's longest row (one host
    sync).  ``n_vars`` [B] drops the literals past each lane's problem
    variables: the reduced space's rows (the watched arm's entry round),
    as ``core.derive_planes`` drops them from the reduced planes."""
    lb = lit_bytes(W)
    if n_vars is not None:
        keep = clauses.abs() <= n_vars.view(-1, 1, 1)
        clauses = torch.where(keep, clauses, 0)
    lits, k = _lists(clauses)
    mlits, m = _lists(torch.where(card_ids >= 0, card_ids + 1, 0))
    k, m = torch.stack([k, m]).tolist()
    dtype = torch.int16 if lb == 2 else torch.int32
    return Compact(_cut(lits, _width(k, lb), dtype),
                   _cut(mlits, _width(m, lb), dtype))


def rows_for(clauses: torch.Tensor, card_ids: torch.Tensor, W: int,
             rows: Optional[Compact] = None,
             n_vars: Optional[torch.Tensor] = None) -> Compact:
    """The compact rows a launch on ``clauses``/``card_ids`` reads:
    ``rows`` when the caller built them, checked against the batch, else
    built here (``n_vars`` as for :func:`compact_rows`)."""
    if rows is None:
        return compact_rows(clauses, card_ids, W, n_vars)
    B, C = clauses.shape[:2]
    NA = card_ids.shape[1]
    if (tuple(rows.lits.shape[:2]) != (B, C)
            or tuple(rows.mlits.shape[:2]) != (B, NA)
            or rows.lits.device != clauses.device
            or rows.mlits.device != clauses.device
            or rows.lits.dtype != rows.mlits.dtype
            or rows.lit_bytes != lit_bytes(W)):
        raise ValueError(f"compact rows must be {lit_bytes(W)}-byte lists "
                         f"[{B}, {C}, *] and [{B}, {NA}, *] on "
                         f"{clauses.device}")
    return rows


def launch_args(rows: Compact, W: int, tile: int):
    """(lits, mlits, K, M, lit_bytes, tile_rows, resident) of a kernel
    launch on ``rows``; raises when they do not fit shared memory."""
    B, C, K = rows.lits.shape
    NA, M = rows.mlits.shape[1:]
    lb = rows.lit_bytes
    keep = resident(rows, W, tile)
    need = _fixed_bytes(W, NA, M, lb) + (
        _list_bytes(C, K, lb) if keep else 2 * _list_bytes(tile, K, lb))
    if need > SMEM_BYTES:
        raise ValueError(f"compact rows need {need} bytes of shared memory, "
                         f"more than {SMEM_BYTES}")
    return (rows.lits.data_ptr(), rows.mlits.data_ptr(), K, M, lb, tile,
            int(keep))


def bcp_fixpoint(clauses, card_ids, card_active, card_n, min_bits, min_w,
                 t0, f0, en, block_rows: int, rows: Optional[Compact] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched blockwise fixpoint.  int32 inputs: clauses [B, C, K] and
    card_ids [B, NA, M] as in ``core.ProblemTensors``, card_active/card_n
    [B, NA], min_bits/t0/f0 [B, W], min_w/en [B]; ``rows`` their compact
    rows when the caller has them (:func:`rows_for`).  Returns (conflict
    int32[B], t, f int32[B, W])."""
    B, C, K = clauses.shape
    NA, M = card_ids.shape[1:]
    W = t0.shape[1]
    args = dict(clauses=clauses, card_ids=card_ids, card_active=card_active,
                card_n=card_n, min_bits=min_bits, min_w=min_w, t0=t0, f0=f0,
                en=en)
    shapes = dict(clauses=(B, C, K), card_ids=(B, NA, M),
                  card_active=(B, NA), card_n=(B, NA), min_bits=(B, W),
                  min_w=(B,), t0=(B, W), f0=(B, W), en=(B,))
    dev = _check_args(args, shapes)
    tile = tile_rows(block_rows, C, K, M, W, NA)
    if dev.type == "cpu":
        pos, neg = core._batch_planes(clauses, W)
        mem = core._batch_index_planes(card_ids, W)
        return bcp_fixpoint_plain(pos, neg, mem, card_active, card_n,
                                  min_bits, min_w, t0, f0, en,
                                  block_rows=tile)
    lib = _build.load()
    rows = rows_for(clauses, card_ids, W, rows)
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    t = torch.empty((B, W), dtype=torch.int32, device=dev)
    f = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    la = launch_args(rows, W, tile)
    rc = lib.deppy_blockwise_fixpoint(
        *la[:2], card_active.data_ptr(), card_n.data_ptr(),
        min_bits.data_ptr(), min_w.data_ptr(), t0.data_ptr(), f0.data_ptr(),
        en.data_ptr(), conflict.data_ptr(), t.data_ptr(), f.data_ptr(), B, C,
        NA, W, *la[2:], THREADS, stream)
    counts.count("blockwise_fixpoint", "blockwise", "block", None)
    _build.check(rc, "blockwise_fixpoint")
    return conflict, t, f


def bcp_fixpoint_plain(pos, neg, mem, card_active, card_n, min_bits, min_w,
                       t0, f0, en, block_rows: int):
    """The plain version of :func:`bcp_fixpoint`, on any device, on dense
    planes (pos/neg [B, C, W], mem [B, NA, W]) with blocks of
    ``min(block_rows, C)`` rows."""
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
