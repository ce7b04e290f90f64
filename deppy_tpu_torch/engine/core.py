"""Tensor data model, bit primitives and plain phases (port of ``deppy_tpu/engine/core.py:56-1621``).

Three layers, in the reference's order:

* the data model (:class:`ProblemTensors`, :class:`SolveResult`) and the
  bitplane primitives (``_srl``, :func:`popcount32`, :func:`pack_mask`,
  :func:`unpack_mask`) — ``core.py:56-308``;
* :func:`derive_planes`, which packs the compact clause and AtMost
  tensors into int32 bitplanes on the device — ``core.py:540-616``;
* the plain versions of the CUDA kernels: :func:`round_planes`,
  :func:`planes_fixpoint` and its arms (the bits rounds, the blockwise
  sweeps :func:`_fixpoint_blockwise_u` of ``pallas_blockwise.py:67-190``,
  the gather rounds :func:`bcp_round` of ``core.py:428-486`` and the
  watched fixpoint of :mod:`.clause_bank`), :func:`dpll`, :func:`search`,
  :func:`search_phase`, :func:`minimize_phase` and :func:`core_phase`
  (``core.py:361-1621``).  They solve ONE problem with Python control
  flow over torch tensors.  The CPU path and the tests run them; the
  CUDA main path never does (the kernel wrappers in
  :mod:`deppy_tpu_torch.engine.cuda_bcp`,
  :mod:`deppy_tpu_torch.engine.cuda_blockwise` and
  :mod:`deppy_tpu_torch.engine.cuda_search` launch the kernels there).

The BCP impl is selected as in the reference (``core.py:488-508,
634-641``): :func:`set_bcp_impl` or the ``DEPPY_GPU_BCP`` knob, one of
the reference's six names.  ``bits`` (and ``auto``) runs phases 1-2 in
the reduced plane space with the dense rounds; ``watched`` runs them in
the reduced space too, every fixpoint implication-driven over the
problem's clause bank (the dense rounds where the batch got dummy
banks); ``blockwise``, ``pallas`` and ``gather`` run them in the full
space, every fixpoint a sweep over blocks of clause rows, the dense
rounds (the reference's ``pallas`` impl is its kernel 1), or Jacobi
rounds over the raw clause rows, counting per occurrence.  Phase 3 runs
in the full space under every impl, each with its own fixpoint.

Planes are packed int32 words as in the reference: variable ``v`` is bit
``v % 32`` of word ``v // 32``, so variable 31 of every word is the sign
bit.  Torch's ``>>`` on int32 is arithmetic, so the plain versions work on
the words widened to int64 and masked to 32 bits (``_to_u``), where every
shift is logical, and narrow back with :func:`_to_i32` at their edges.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import torch

# Assignment values (same convention as the reference engine).
TRUE = 1
FALSE = -1
UNASSIGNED = 0

# Outcomes.  RUNNING doubles as UNKNOWN / Incomplete.
SAT = 1
UNSAT = -1
RUNNING = 0

# Bits per bitplane word.
WORD = 32

# Deletion-probe chunk width of the unsat-core phase (core.py:1545).
CORE_CHUNK = 8

# Propagation rounds, and blockwise sweeps, the plain versions have run (a
# kernel runs the same rounds on the same inputs, so these count a
# kernel's work too).
plain_rounds = 0
plain_sweeps = 0

# BCP implementation (core.py:506-508).
_BCP_IMPLS = ("auto", "gather", "bits", "pallas", "blockwise", "watched")
_BCP_IMPL = os.environ.get("DEPPY_GPU_BCP", "auto")

_U32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64


class ProblemTensors(NamedTuple):
    """A batch of lowered problems padded to common shapes.

    Field for field the reference's ``ProblemTensors`` (core.py:72-122).
    Every tensor is int32 with a leading batch axis ``[B, ...]``; clause
    literals are signed 1-based with 0 padding, every other index tensor
    0-based with -1 padding.  Plane fields hold packed words (``Wv =
    ceil(V/32)`` over the full space ``V = NV + NCON``, ``Wr =
    ceil(NV/32)`` over the problem variables), or ``[B, rows, 1]`` zero
    placeholders when not derived.  The clause-bank fields
    (:mod:`.clause_bank`) hold the watched impl's adjacency, ``Ob`` and
    ``Oc`` entries a row, or ``[B, 1, 1]`` dummies of -1 when not
    derived."""

    clauses: torch.Tensor          # [B, C, K]
    card_ids: torch.Tensor         # [B, NA, M]
    card_n: torch.Tensor           # [B, NA]
    card_act: torch.Tensor         # [B, NA]   (-1 on padded rows)
    anchors: torch.Tensor          # [B, A]    (-1 padded)
    choice_cand: torch.Tensor      # [B, NC, Kc]
    var_choices: torch.Tensor      # [B, NV, W]
    n_vars: torch.Tensor           # [B]
    n_cons: torch.Tensor           # [B]
    pos_bits: torch.Tensor         # [B, C, Wv]
    neg_bits: torch.Tensor         # [B, C, Wv]
    card_member_bits: torch.Tensor  # [B, NA, Wv]
    card_act_bits: torch.Tensor    # [B, NA, Wv]
    pos_bits_r: torch.Tensor       # [B, C, Wr]
    neg_bits_r: torch.Tensor       # [B, C, Wr]
    card_member_bits_r: torch.Tensor  # [B, NA, Wr]
    card_valid: torch.Tensor       # [B, NA]  1 on real AtMost rows
    occ_pos: torch.Tensor          # [B, V, Ob]  clause rows holding +v
    occ_neg: torch.Tensor          # [B, V, Ob]  clause rows holding -v
    occ_pos_r: torch.Tensor        # [B, NV, Ob] the same, reduced space
    occ_neg_r: torch.Tensor        # [B, NV, Ob]
    card_occ: torch.Tensor         # [B, NV, Oc] AtMost rows of each member


class SolveResult(NamedTuple):
    """One problem's result (core.py:125-135).  ``trace_stack`` is the
    backtrack trace (tracer.go:13-15): row ``i`` is the guess-variable
    stack, -1 padded, at the ``i``-th search backtrack, ``[T, GS]`` for
    a trace capacity ``T`` (0 = tracing off) and ``GS = NC + 1``.
    ``trace_n`` counts every backtrack, so ``trace_n > T`` means the
    buffer truncated."""

    outcome: int            # SAT / UNSAT / RUNNING (= incomplete)
    installed: torch.Tensor  # bool[NV]
    core: torch.Tensor      # bool[NCON]
    steps: int
    trace_stack: torch.Tensor  # int32[T, GS]
    trace_n: int            # search backtracks


def lane(pts: ProblemTensors, b: int) -> ProblemTensors:
    """Lane ``b`` of a batch, without its batch axis."""
    return ProblemTensors(*[x[b] for x in pts])


# --------------------------------------------------------------------------
# BCP impl selection (core.py:634-641, 799-815, 1672-1675)


def _check_impl(name: str) -> str:
    if name not in _BCP_IMPLS:
        raise ValueError(f"unknown BCP impl {name!r}")
    return name


def set_bcp_impl(name: str) -> None:
    """Select the BCP implementation: ``auto`` (= ``bits``), ``bits``,
    ``watched``, ``blockwise``, ``pallas`` or ``gather`` (see the module
    docstring)."""
    global _BCP_IMPL
    _BCP_IMPL = _check_impl(name)


def resolved_impl() -> str:
    """The impl a solve runs: ``auto`` resolves to ``bits``."""
    impl = _check_impl(_BCP_IMPL)
    return "bits" if impl == "auto" else impl


def phases_reduced() -> bool:
    """Whether phases 1-2 run in the reduced problem-var plane space."""
    return resolved_impl() in ("bits", "watched")


# --------------------------------------------------------------------------
# int32 <-> u32-in-int64 and the bitplane primitives


def _to_u(x: torch.Tensor) -> torch.Tensor:
    """int32 words → int64 holding the same 32 bits as an unsigned value."""
    return x.to(_I64) & _U32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit words → int32 (bit 31 becomes the sign)."""
    x = x & _U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(_I32)


def _srl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift on int32 (the sign bit is data, not sign)."""
    return _to_i32(_to_u(x) >> n)


def _popcount_u(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of unsigned 32-bit words held in int64."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v + (v >> 8) + (v >> 16) + (v >> 24)) & 0x3F


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bitplanes (core.py:190-196)."""
    return _popcount_u(_to_u(v)).to(_I32)


_SHIFTS: dict = {}


def _shifts(device) -> torch.Tensor:
    key = str(device)
    if key not in _SHIFTS:
        _SHIFTS[key] = torch.arange(WORD, dtype=_I64, device=device)
    return _SHIFTS[key]


def pack_mask(mask: torch.Tensor, W: int) -> torch.Tensor:
    """bool[..., V] → packed int32[..., W] (core.py:290-300).  Bit
    positions are distinct, so the sum is an OR and carries nothing."""
    V = mask.shape[-1]
    pad = W * WORD - V
    m = mask.to(_I64)
    if pad > 0:
        m = torch.nn.functional.pad(m, (0, pad))
    elif pad < 0:
        raise ValueError(f"mask of {V} bits does not fit {W} words")
    m = m.reshape(mask.shape[:-1] + (W, WORD))
    return _to_i32((m << _shifts(mask.device)).sum(-1))


def unpack_mask(words: torch.Tensor, V: int) -> torch.Tensor:
    """packed int32[..., W] → bool[..., V] (core.py:303-307)."""
    u = _to_u(words)
    bits = (u.unsqueeze(-1) >> _shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :V].to(torch.bool)


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the rows of unsigned words [R, W] → [W], folding
    the rows in halves (log2(R) ORs of shrinking halves)."""
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        x = x[0::2] | x[1::2]
    return x[0]


def planes_to_assign(t: torch.Tensor, f: torch.Tensor, V: int) -> torch.Tensor:
    """(t, f) int32 planes → int32 assignment [..., V] (core.py:969-975)."""
    tb = unpack_mask(t, V)
    fb = unpack_mask(f, V)
    one = torch.ones((), dtype=_I32, device=t.device)
    return torch.where(tb, one * TRUE, torch.where(fb, one * FALSE, one * 0))


# --------------------------------------------------------------------------
# assignment construction (batched over any leading axes of ``pt``)


def _base_assignment(pt: ProblemTensors, V: int, NCON: int,
                     act_enabled: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Problem vars unassigned, activation vars true unless an explicit
    ``act_enabled: bool[..., NCON]`` subset is given, padding pinned false
    (core.py:142-159)."""
    idx = torch.arange(V, dtype=_I32, device=pt.n_vars.device)
    n_vars = pt.n_vars.unsqueeze(-1)
    n_cons = pt.n_cons.unsqueeze(-1)
    in_act = (idx >= n_vars) & (idx < n_vars + n_cons)
    if act_enabled is None:
        act_val = torch.full_like(in_act, TRUE, dtype=_I32)
    else:
        j = (idx - n_vars).clamp(0, NCON - 1).to(_I64)
        on = torch.gather(act_enabled, -1, j)
        act_val = torch.where(on, TRUE, UNASSIGNED).to(_I32)
    fill = torch.full_like(act_val, FALSE)
    out = torch.where(in_act, act_val, fill)
    return torch.where(idx < n_vars, torch.zeros_like(out), out)


def _base_assignment_red(pt: ProblemTensors, NV: int) -> torch.Tensor:
    """Reduced-space base assignment: padding past ``n_vars`` pinned false
    (core.py:162-167)."""
    idx = torch.arange(NV, dtype=_I32, device=pt.n_vars.device)
    un = idx < pt.n_vars.unsqueeze(-1)
    return torch.where(un, UNASSIGNED, FALSE).to(_I32)


def _anchor_mask(pt: ProblemTensors, V: int) -> torch.Tensor:
    """bool[..., V]: the anchor (Mandatory) variables.  A -1 pad matches
    no index, which is ``.at[].set(mode="drop")`` (core.py:176-178)."""
    idx = torch.arange(V, dtype=_I32, device=pt.anchors.device)
    return (pt.anchors.unsqueeze(-1) == idx).any(-2)


def _apply_anchors(pt: ProblemTensors, assign: torch.Tensor,
                   V: int) -> torch.Tensor:
    """Assume every anchor true (core.py:170-173)."""
    return torch.where(_anchor_mask(pt, V), TRUE, assign).to(_I32)


# --------------------------------------------------------------------------
# plane derivation (core.py:540-616)


def _batch_planes(clauses: torch.Tensor, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C, K] signed literals → (pos, neg) packed int32 [B, C, W]."""
    w_idx = torch.arange(W, dtype=_I64, device=clauses.device)
    shape = clauses.shape[:-1] + (W,)
    acc_p = torch.zeros(shape, dtype=_I64, device=clauses.device)
    acc_n = torch.zeros_like(acc_p)
    lits = clauses.to(_I64)
    for k in range(clauses.shape[-1]):
        lit = lits[..., k]
        v = torch.where(lit != 0, lit.abs() - 1, 0)
        onehot = (v >> 5).unsqueeze(-1) == w_idx
        bit = (1 << (v & 31)).unsqueeze(-1)
        acc_p = acc_p | torch.where(onehot & (lit > 0).unsqueeze(-1), bit, 0)
        acc_n = acc_n | torch.where(onehot & (lit < 0).unsqueeze(-1), bit, 0)
    return _to_i32(acc_p), _to_i32(acc_n)


def _batch_index_planes(rows: torch.Tensor, W: int) -> torch.Tensor:
    """[B, R, M] 0-based indices (-1 pad) → packed int32 [B, R, W]."""
    w_idx = torch.arange(W, dtype=_I64, device=rows.device)
    acc = torch.zeros(rows.shape[:-1] + (W,), dtype=_I64, device=rows.device)
    idx = rows.to(_I64)
    for m in range(rows.shape[-1]):
        v0 = idx[..., m]
        valid = v0 >= 0
        v = torch.where(valid, v0, 0)
        onehot = (v >> 5).unsqueeze(-1) == w_idx
        bit = (1 << (v & 31)).unsqueeze(-1)
        acc = acc | torch.where(onehot & valid.unsqueeze(-1), bit, 0)
    return _to_i32(acc)


def derive_planes(clauses: torch.Tensor, card_ids: torch.Tensor,
                  card_act: torch.Tensor, n_vars: torch.Tensor,
                  *, Wv: int, Wr: int, red: bool, full: bool = True
                  ) -> Tuple[torch.Tensor, ...]:
    """Packed bitplane fields of :class:`ProblemTensors` from the compact
    tensors, batched and on their device (core.py:578-616).  Returns
    (pos_bits, neg_bits, card_member_bits, card_act_bits, pos_bits_r,
    neg_bits_r, card_member_bits_r); a space not asked for comes back as
    ``[B, rows, 1]`` zero placeholders."""
    B, C, _ = clauses.shape
    NA = card_ids.shape[1]
    dev = clauses.device

    def zeros(rows):
        return torch.zeros((B, rows, 1), dtype=_I32, device=dev)

    if full:
        pos, neg = _batch_planes(clauses, Wv)
        member = _batch_index_planes(card_ids, Wv)
        act_bits = _batch_index_planes(card_act.unsqueeze(-1), Wv)
    else:
        pos, neg, member, act_bits = zeros(C), zeros(C), zeros(NA), zeros(NA)
    if red:
        keep = clauses.abs() <= n_vars.view(B, 1, 1)
        pos_r, neg_r = _batch_planes(torch.where(keep, clauses, 0), Wr)
        mem_r = _batch_index_planes(card_ids, Wr)
    else:
        pos_r, neg_r, mem_r = zeros(C), zeros(C), zeros(NA)
    return pos, neg, member, act_bits, pos_r, neg_r, mem_r


def with_planes(pts: ProblemTensors, *, Wv: int, Wr: int, red: bool,
                full: bool) -> ProblemTensors:
    """``pts`` with its plane fields derived on its device."""
    pos, neg, mem, act, pos_r, neg_r, mem_r = derive_planes(
        pts.clauses, pts.card_ids, pts.card_act, pts.n_vars,
        Wv=Wv, Wr=Wr, red=red, full=full)
    if not full:
        pos, neg, mem, act = (pts.pos_bits, pts.neg_bits,
                              pts.card_member_bits, pts.card_act_bits)
    if not red:
        pos_r, neg_r, mem_r = (pts.pos_bits_r, pts.neg_bits_r,
                               pts.card_member_bits_r)
    return pts._replace(pos_bits=pos, neg_bits=neg, card_member_bits=mem,
                        card_act_bits=act, pos_bits_r=pos_r,
                        neg_bits_r=neg_r, card_member_bits_r=mem_r)


# --------------------------------------------------------------------------
# propagation (plain versions of the fixpoint kernel, core.py:361-966)


def _round_u(pos, neg, mem, card_active, card_n, min_bits, min_w, t, f):
    """One propagation round on unsigned words held in int64 (the body of
    :func:`round_planes`).  Returns (conflict, new_t, new_f, changed) with
    the two flags as 0-d bool tensors."""
    a = t | f
    sat = (((pos & t) | (neg & f)) != 0).any(-1)
    upos = pos & ~a
    uneg = neg & ~a
    n_un = _popcount_u(upos).sum(-1) + _popcount_u(uneg).sum(-1)
    valid = ((pos | neg) != 0).any(-1)
    dead = valid & ~sat & (n_un == 0)
    unit = (valid & ~sat & (n_un == 1)).unsqueeze(-1)
    wpos = _or_rows(torch.where(unit, upos, 0))
    wneg = _or_rows(torch.where(unit, uneg, 0))

    # AtMost rows: > n true members conflicts, == n forces the rest false.
    trues = _popcount_u(mem & t).sum(-1)
    unk = _popcount_u(mem & ~a).sum(-1)
    over = card_active & (trues > card_n)
    full = (card_active & (trues == card_n) & (unk > 0)).unsqueeze(-1)
    wneg = wneg | _or_rows(torch.where(full, mem & ~a, 0))

    # Dynamic "at most w of the extras" bound (phase 2's probes).
    mtrues = _popcount_u(min_bits & t).sum()
    min_over = mtrues > min_w
    wneg = torch.where(mtrues == min_w, wneg | (min_bits & ~a), wneg)

    conflict = dead.any() | over.any() | min_over | ((wpos & wneg) != 0).any()
    new_t = t | (wpos & ~a)
    new_f = f | (wneg & ~a)
    changed = ((new_t != t).any() | (new_f != f).any()) & ~conflict
    return conflict, new_t, new_f, changed


def round_planes(pos, neg, mem, card_active, card_n2, min_bits, min_w, t, f):
    """One propagation round (core.py:361-421) on int32 planes: pos/neg
    [C, W], mem [NA, W], card_active bool[NA], card_n2 [NA], min_bits/t/f
    [W], min_w an int.  Returns (conflict, new_t, new_f, changed)."""
    c, nt, nf, ch = _round_u(_to_u(pos), _to_u(neg), _to_u(mem),
                             card_active.reshape(-1).to(torch.bool),
                             card_n2.reshape(-1).to(_I64), _to_u(min_bits),
                             int(min_w), _to_u(t), _to_u(f))
    return bool(c), _to_i32(nt), _to_i32(nf), bool(ch)


class Arm(NamedTuple):
    """What the watched and gather fixpoints read besides the planes, for
    one problem.  ``impl`` is ``"watched"`` (the implication-driven
    fixpoint over the bank ``occ_pos``/``occ_neg`` [Vb, Ob] and
    ``card_occ`` [NVb, Oc], its visits dropping literals past ``n_vars``
    under ``red``) or ``"gather"`` (Jacobi rounds over the raw rows,
    AtMost activity from ``card_act`` and each round's assignment, or
    the static ``card_valid`` of the space when ``card_act`` is None)."""

    impl: str
    clauses: torch.Tensor             # [C, K] raw signed literals
    card_ids: torch.Tensor            # [NA, M] raw members, -1 pad
    card_act: Optional[torch.Tensor]  # [NA] activation variable, -1 pad
    n_vars: int
    occ_pos: Optional[torch.Tensor] = None
    occ_neg: Optional[torch.Tensor] = None
    card_occ: Optional[torch.Tensor] = None
    red: bool = False


class _Space(NamedTuple):
    """One problem's planes in one space, widened for the plain rounds.
    ``card_act_bits`` is set in the full space only: there AtMost-row
    activity follows the activation bits of each fixpoint's entry state
    (core.py:900-902); the reduced space uses the static ``card_valid``.
    The fixpoint: ``arm`` when set (:class:`Arm`), else blockwise sweeps
    over blocks of ``block_rows`` clause rows when that is positive
    (:func:`_fixpoint_blockwise_u`), else the dense rounds."""

    pos: torch.Tensor
    neg: torch.Tensor
    mem: torch.Tensor
    card_n: torch.Tensor
    card_valid: torch.Tensor
    card_act_bits: Optional[torch.Tensor]
    block_rows: int = 0
    arm: Optional[Arm] = None


def _arm(pt: ProblemTensors, red: bool, impl: str) -> Optional[Arm]:
    """The fixpoint arm of ``impl`` for one problem: the watched arm when
    its bank in the space is real (a dummy bank falls through to the
    dense rounds, core.py:903-920), the gather arm, or None."""
    if impl == "watched":
        from . import clause_bank

        occ_p = pt.occ_pos_r if red else pt.occ_pos
        occ_n = pt.occ_neg_r if red else pt.occ_neg
        if not clause_bank.bank_ready(occ_p):
            return None
        return Arm("watched", pt.clauses, pt.card_ids, None, int(pt.n_vars),
                   occ_p, occ_n, pt.card_occ, red)
    if impl == "gather":
        if red:
            raise ValueError("the gather impl runs in the full plane space")
        return Arm("gather", pt.clauses, pt.card_ids, pt.card_act,
                   int(pt.n_vars))
    return None


def _space(pt: ProblemTensors, red: bool, block_rows: int = 0,
           impl: str = "bits") -> _Space:
    arm = _arm(pt, red, impl)
    if red:
        return _Space(_to_u(pt.pos_bits_r), _to_u(pt.neg_bits_r),
                      _to_u(pt.card_member_bits_r), pt.card_n.to(_I64),
                      pt.card_valid != 0, None, block_rows, arm)
    return _Space(_to_u(pt.pos_bits), _to_u(pt.neg_bits),
                  _to_u(pt.card_member_bits), pt.card_n.to(_I64),
                  pt.card_valid != 0, _to_u(pt.card_act_bits), block_rows,
                  arm)


def _row_activity(S: _Space, t) -> torch.Tensor:
    """bool[NA]: the AtMost rows active for a fixpoint from ``t``."""
    if S.card_act_bits is None:
        return S.card_valid
    return ((S.card_act_bits & t) != 0).any(-1)


def _fixpoint_u(S: _Space, t, f, min_bits, min_w: int, run: bool,
                pre_check: bool = True):
    """Propagate to fixpoint from (t, f) (core.py:861-966) by the space's
    fixpoint (:class:`_Space`).  A disabled run does zero rounds.  With
    ``pre_check`` an entry state that already sets some variable both
    ways is the conflict (core.py:877-883); the standalone kernels
    (pallas_bcp.py, pallas_blockwise.py) have no such check.  Returns
    (conflict: bool, t, f)."""
    if not run:
        return False, t, f
    if pre_check and bool(((t & f) != 0).any()):
        return True, t, f
    if S.arm is not None and S.arm.impl == "watched":
        from . import clause_bank

        A = S.arm
        return clause_bank._watched_u(
            A.clauses, A.n_vars, A.occ_pos, A.occ_neg, A.card_occ, S.pos,
            S.neg, S.mem, _row_activity(S, t), S.card_n, min_bits, min_w, t,
            f, True, A.red)
    if S.arm is not None:
        return _gather_u(S, t, f, min_bits, min_w)
    if S.block_rows:
        return _fixpoint_blockwise_u(S, t, f, min_bits, min_w, True,
                                     S.block_rows)
    global plain_rounds
    active = _row_activity(S, t)
    while True:
        plain_rounds += 1
        c, t, f, ch = _round_u(S.pos, S.neg, S.mem, active, S.card_n,
                               min_bits, min_w, t, f)
        c, ch = torch.stack([c, ch]).tolist()
        if c:
            return True, t, f
        if not ch:
            return False, t, f


def bcp_round(clauses, card_ids, card_n, active, assign, min_mask,
              min_w: int):
    """One gather round on an assignment (core.py:428-486): every raw
    clause row and AtMost row evaluated per occurrence.  ``clauses``
    [C, K], ``card_ids`` [NA, M], ``card_n`` [NA], ``active`` bool[NA],
    ``assign`` int32[V], ``min_mask`` bool[V].  Returns (conflict, new
    assignment, changed) with the flags as 0-d bool tensors.  A variable
    forced both ways is the conflict and comes out true."""
    V = assign.shape[0]
    cls_mask = clauses != 0
    cls_var = torch.where(cls_mask, clauses.abs() - 1, 0).long()
    cls_sign = torch.sign(clauses)
    vals = torch.where(cls_mask, assign[cls_var] * cls_sign, FALSE)
    satc = (vals == TRUE).any(1)
    n_un = (vals == UNASSIGNED).sum(1)
    valid = cls_mask.any(1)
    dead = valid & ~satc & (n_un == 0)
    unit = valid & ~satc & (n_un == 1)
    ucol = torch.argmax((vals == UNASSIGNED).to(torch.int8), 1, keepdim=True)
    uvar = cls_var.gather(1, ucol)[:, 0]
    usign = cls_sign.gather(1, ucol)[:, 0]
    wpos = torch.zeros(V, dtype=torch.bool, device=assign.device)
    wneg = torch.zeros_like(wpos)
    wpos[uvar[unit & (usign > 0)]] = True
    wneg[uvar[unit & (usign < 0)]] = True

    # AtMost rows: > n true members conflicts, == n forces the rest false.
    card_mask = card_ids >= 0
    card_var = torch.where(card_mask, card_ids, 0).long()
    mvals = assign[card_var]
    trues = ((mvals == TRUE) & card_mask).sum(1)
    unk = ((mvals == UNASSIGNED) & card_mask).sum(1)
    over = active & (trues > card_n)
    full = active & (trues == card_n) & (unk > 0)
    force = full.unsqueeze(1) & card_mask & (mvals == UNASSIGNED)
    wneg[card_var[force]] = True

    # Dynamic "at most min_w of the extras" bound.
    mtrues = ((assign == TRUE) & min_mask).sum()
    min_over = mtrues > min_w
    if int(mtrues) == min_w:
        wneg = wneg | ((assign == UNASSIGNED) & min_mask)

    conflict = dead.any() | over.any() | min_over | (wpos & wneg).any()
    unas = assign == UNASSIGNED
    new = torch.where(unas & wpos, TRUE,
                      torch.where(unas & wneg, FALSE, assign)).to(_I32)
    changed = (new != assign).any() & ~conflict
    return conflict, new, changed


def _gather_u(S: _Space, t, f, min_bits, min_w: int):
    """The gather fixpoint (core.py:818-832) of ``S.arm`` from unsigned
    planes: rounds of :func:`bcp_round` over the assignment until one
    conflicts or changes nothing.  AtMost activity is re-read every round
    from ``card_act`` (static ``card_valid`` when it is None).  Returns
    (conflict: bool, t, f)."""
    global plain_rounds
    A = S.arm
    W = t.shape[0]
    V = W * WORD
    assign = planes_to_assign(_to_i32(t), _to_i32(f), V)
    min_mask = unpack_mask(_to_i32(min_bits), V)
    if A.card_act is not None:
        valid = A.card_act >= 0
        act_idx = torch.where(valid, A.card_act, 0).long()
    while True:
        plain_rounds += 1
        if A.card_act is None:
            active = S.card_valid
        else:
            active = valid & (assign[act_idx] == TRUE)
        c, assign, ch = bcp_round(A.clauses, A.card_ids, S.card_n, active,
                                  assign, min_mask, min_w)
        c, ch = torch.stack([c, ch]).tolist()
        if c or not ch:
            break
    return (bool(c), _to_u(pack_mask(assign == TRUE, W)),
            _to_u(pack_mask(assign == FALSE, W)))


def _fixpoint_blockwise_u(S: _Space, t, f, min_bits, min_w: int, run: bool,
                          block_rows: int):
    """The blockwise fixpoint (pallas_blockwise.bcp_fixpoint, :147-190):
    Gauss-Seidel sweeps over blocks of ``min(block_rows, C)`` clause rows,
    a partial last block standing for the reference's zero-row padding
    (:167-171).  Each block runs its local fixpoint of rounds until one
    changes nothing; t/f carry from block to block; the AtMost rows are
    active in block 0 only (:89); the extras row is evaluated in every
    block; once a sweep has conflicted no later block runs a round (:91).
    Sweeps repeat until one changes nothing or conflicts (:173-190).  No
    entry-overlap check, as in the kernel.  Returns (conflict, t, f)."""
    global plain_rounds, plain_sweeps
    if not run:
        return False, t, f
    C = S.pos.shape[0]
    br = min(block_rows, C)
    active = _row_activity(S, t)
    inactive = torch.zeros_like(active)
    while True:
        plain_sweeps += 1
        changed = False
        for lo in range(0, C, br):
            act = active if lo == 0 else inactive
            while True:
                plain_rounds += 1
                c, t, f, ch = _round_u(S.pos[lo:lo + br], S.neg[lo:lo + br],
                                       S.mem, act, S.card_n, min_bits, min_w,
                                       t, f)
                c, ch = torch.stack([c, ch]).tolist()
                if c:
                    return True, t, f
                if not ch:
                    break
                changed = True
        if not changed:
            return False, t, f


def planes_fixpoint(pt: ProblemTensors, t: torch.Tensor, f: torch.Tensor,
                    min_bits: torch.Tensor, min_w: int, enabled: bool,
                    red: bool = False, block_rows: int = 0,
                    impl: str = "bits"):
    """Fixpoint on one problem's int32 planes [W] (core.py:861-966), with
    the entry-overlap check, by ``impl``'s fixpoint: the watched arm on a
    real bank, the gather rounds, blockwise sweeps when ``block_rows`` is
    positive, else the dense rounds (see :class:`_Space`).  Returns
    (conflict, t, f)."""
    c, t, f = _fixpoint_u(_space(pt, red, block_rows, impl), _to_u(t),
                          _to_u(f), _to_u(min_bits), int(min_w),
                          bool(enabled))
    return c, _to_i32(t), _to_i32(f)


def test_outcome(conflict: bool, t, f, pvb) -> int:
    """UNSAT on conflict, SAT when propagation totalizes the problem vars,
    else RUNNING (core.py:991-1002).  Unsigned words."""
    if conflict:
        return UNSAT
    return SAT if not bool(((pvb & ~(t | f)) != 0).any()) else RUNNING


def _set_bit(plane: torch.Tensor, var: int) -> torch.Tensor:
    out = plane.clone()
    out[var // WORD] |= 1 << (var % WORD)
    return out


def _first_unassigned(un_words: List[int]) -> Tuple[bool, int]:
    """(has_unassigned, lowest unassigned variable) from the unassigned
    problem-var words (pallas_search.py:186-196)."""
    for wi, word in enumerate(un_words):
        if word:
            return True, wi * WORD + ((word & -word).bit_length() - 1)
    return False, 0


# --------------------------------------------------------------------------
# DPLL (core.py:1009-1136)


def dpll(S: _Space, pvb, t_init, f_init, min_bits, min_w: int, budget: int,
         steps: int, NV: int, enabled: bool):
    """Complete search under the partial assignment (t_init, f_init):
    false-first decisions on the lowest unassigned problem variable,
    chronological backtracking, one plane snapshot per decision level.
    Unsigned-word planes.  Returns (status, m_t, m_f, steps); a disabled
    call does nothing and returns RUNNING."""
    conflict0, t0, f0 = _fixpoint_u(S, t_init, f_init, min_bits, min_w,
                                    enabled)
    status = UNSAT if conflict0 else RUNNING
    m_t, m_f = t0, f0
    snap_t = [t0] + [None] * NV
    snap_f = [f0] + [None] * NV
    dec_var = [0] * NV
    dec_phase = [0] * NV
    sp = 0
    flip = False
    while enabled and status == RUNNING and steps <= budget:
        lv = min(max(sp, 0), NV)
        t, f = snap_t[lv], snap_f[lv]
        has_un, first_un = _first_unassigned((pvb & ~(t | f)).tolist())
        if not flip and not has_un:
            status = SAT
            m_t, m_f = t, f
            continue
        lvl = min(max(sp, 0), NV - 1)
        if flip:
            var = dec_var[lvl]
            dec_phase[lvl] = TRUE
            conflict, t3, f3 = _fixpoint_u(S, _set_bit(t, var), f, min_bits,
                                           min_w, True)
        else:
            var = first_un
            dec_var[lvl] = var
            dec_phase[lvl] = FALSE
            conflict, t3, f3 = _fixpoint_u(S, t, _set_bit(f, var), min_bits,
                                           min_w, True)
        steps += 1
        if not conflict:
            nxt = min(max(sp + 1, 0), NV)
            snap_t[nxt], snap_f[nxt] = t3, f3
            if not bool(((pvb & ~(t3 | f3)) != 0).any()):
                status = SAT
                m_t, m_f = t3, f3
            sp += 1
            flip = False
            continue
        # Chronological backtrack: deepest level still on its false phase.
        bt = -1
        for lv_ in range(min(sp, NV - 1), -1, -1):
            if dec_phase[lv_] == FALSE:
                bt = lv_
                break
        if bt < 0:
            status = UNSAT
        else:
            sp = bt
            flip = True
    return status, m_t, m_f, steps


# --------------------------------------------------------------------------
# preference-ordered guess search (core.py:1143-1391)


def search(S: _Space, pvb, t0, f0, outcome0: int, budget: int, steps: int,
           choice_cand: List[List[int]], var_choices: List[List[int]],
           na: int, NV: int, enabled: bool, T: int = 0):
    """The reference guess search for one problem: a circular choice deque
    of (choice row, candidate index) pairs, a guess stack, one plane
    snapshot and Test outcome per guess level, and a DPLL leaf whenever
    the deque empties with the outcome undetermined.  One control step
    takes exactly one arm, in the reference's precedence: leaf, backtrack,
    done, push.  ``T`` is the trace capacity: each of the first ``T``
    backtrack entries (where the reference calls ``Tracer.Trace``,
    search.go:172-173) records the guess-variable stack before the pop,
    -1 padded to ``GS`` (a null guess stays -1), as ``core.py:1225-1233``
    does; later ones are counted, not stored.  Returns (result, assumed,
    m_t, m_f, steps, trace_stack int32[T, GS], backtracks) with planes as
    unsigned words."""
    NC = len(choice_cand)
    Kc = len(choice_cand[0])
    DQ = GS = NC + 1
    W = t0.shape[-1]
    zero = torch.zeros_like(t0)
    dq_c = [i if i < na else 0 for i in range(DQ)]
    dq_i = [0] * DQ
    head, cnt = 0, na
    g_c, g_i, g_v, g_ch = [0] * GS, [0] * GS, [0] * GS, [0] * GS
    gsp = 0
    snap_t = [t0] + [zero] * GS
    snap_f = [f0] + [zero] * GS
    out_st = [outcome0] + [0] * GS
    result = RUNNING
    m_t, m_f = zero, zero
    assumed = [False] * (W * WORD)
    done = need_leaf = False
    tr_rows: List[List[int]] = []
    tr_n = 0

    def clip(x, lo, hi):
        return min(max(x, lo), hi)

    while enabled and not done and steps <= budget:
        while enabled and not done and not need_leaf and steps <= budget:
            is_leaf = cnt == 0 and result == RUNNING
            is_bt = not is_leaf and result == UNSAT
            is_done = not is_leaf and not is_bt and cnt == 0
            is_push = not (is_leaf or is_bt or is_done)
            if is_leaf:
                need_leaf = True
                continue
            if is_done:
                done = True
                continue
            cur_t, cur_f = snap_t[clip(gsp, 0, GS)], snap_f[clip(gsp, 0, GS)]
            if is_bt:
                # PopGuess (search.go:79-98), traced before the pop.
                if tr_n < T:
                    tr_rows.append(g_v[:gsp] + [-1] * (GS - gsp))
                tr_n += 1
                if gsp == 0:
                    done = True
                    continue
                gsp2 = gsp - 1
                gc, gi, gv, gch = g_c[gsp2], g_i[gsp2], g_v[gsp2], g_ch[gsp2]
                head = (head - 1) % DQ
                cnt = cnt - gch + 1
                dq_c[head] = gc
                dq_i[head] = gi + (1 if gv >= 0 else 0)
                if gv >= 0:
                    assumed[gv] = False
                    # The popped level's outcome was recorded at push
                    # time: restoring it re-Tests for free.
                    result = out_st[clip(gsp2, 0, GS)]
                    if result == SAT:
                        m_t = snap_t[clip(gsp2, 0, GS)]
                        m_f = snap_f[clip(gsp2, 0, GS)]
                gsp = gsp2
                steps += 1
                continue
            # PushGuess (search.go:34-77).
            cid = dq_c[clip(head, 0, DQ - 1)]
            idx = dq_i[clip(head, 0, DQ - 1)]
            head_push = (head + 1) % DQ
            cands = choice_cand[clip(cid, 0, NC - 1)]
            ncand = sum(1 for c in cands if c >= 0)
            var = cands[clip(idx, 0, Kc - 1)] if idx < ncand else -1
            if any(c >= 0 and assumed[c] for c in cands):
                var = -1
            nch = 0
            if var >= 0:
                for ch in var_choices[var]:
                    if ch >= 0:
                        p = (head_push + (cnt - 1) + nch) % DQ
                        dq_c[p] = ch
                        dq_i[p] = 0
                        nch += 1
            head = head_push
            cnt = cnt - 1 + nch
            g = clip(gsp, 0, GS - 1)
            g_c[g], g_i[g], g_v[g], g_ch[g] = cid, idx, var, nch
            sidx = clip(gsp + 1, 0, GS)
            if var >= 0:
                assumed[var] = True
                conflict, t3, f3 = _fixpoint_u(S, _set_bit(cur_t, var), cur_f,
                                               zero, 0, True)
                push_out = test_outcome(conflict, t3, f3, pvb)
                snap_t[sidx], snap_f[sidx] = t3, f3
                out_st[sidx] = push_out
                result = push_out
                if push_out == SAT:
                    m_t, m_f = t3, f3
            else:
                # A null guess copies the level and its outcome.
                snap_t[sidx], snap_f[sidx] = cur_t, cur_f
                out_st[sidx] = out_st[clip(gsp, 0, GS)]
            gsp += 1
            steps += 1
        # Leaf: one full DPLL from the current level (search.go:167-169).
        leaf_status, leaf_t, leaf_f, steps = dpll(
            S, pvb, snap_t[clip(gsp, 0, GS)], snap_f[clip(gsp, 0, GS)],
            zero, 0, budget, steps, NV, enabled=need_leaf)
        if need_leaf:
            result = leaf_status
            if leaf_status == SAT:
                m_t, m_f = leaf_t, leaf_f
        need_leaf = False
    if not done:
        result = RUNNING
    assumed_plane = pack_mask(
        torch.tensor(assumed, dtype=torch.bool, device=t0.device), W)
    tr_stack = torch.full((T, GS), -1, dtype=_I32, device=t0.device)
    if tr_rows:
        tr_stack[: len(tr_rows)] = torch.tensor(tr_rows, dtype=_I32)
    return result, _to_u(assumed_plane), m_t, m_f, steps, tr_stack, tr_n


# --------------------------------------------------------------------------
# the three phases for one problem (core.py:1398-1621)


def _phase_space(pt: ProblemTensors, red: bool, NCON: Optional[int]):
    """(V, W) of phases 1-2: the reduced space ``V = NV`` or the full
    space ``V = NV + NCON``, ``W = ceil(V / 32)``."""
    NV = pt.var_choices.shape[0]
    if red:
        return NV, -(-NV // WORD)
    if NCON is None:
        raise ValueError("the full plane space needs the batch's NCON")
    return NV + NCON, -(-(NV + NCON) // WORD)


def _phase_base(pt: ProblemTensors, red: bool, V: int,
                NCON: Optional[int]) -> torch.Tensor:
    """Base assignment of phases 1-2 in their space (core.py:1419-1422)."""
    if red:
        return _base_assignment_red(pt, V)
    return _base_assignment(pt, V, NCON)


def search_phase(pt: ProblemTensors, budget: int, en: bool = True, *,
                 red: bool = True, NCON: Optional[int] = None,
                 block_rows: int = 0, impl: str = "bits", T: int = 0):
    """Phase 1 (core.py:1398-1444): the baseline Test under the anchors,
    then the guess search when it is undetermined.  ``red`` selects the
    reduced space (``V = NV``) or the full one (``V = NV + NCON``, the
    activation variables set true), ``block_rows`` and ``impl`` the
    fixpoint (see :class:`_Space`), ``T`` the trace capacity (see
    :func:`search`).  Returns (result, guessed bool[NV], model int32[NV],
    steps, trace_stack int32[T, NC + 1], backtracks): the full space's
    outputs cut to the first NV variables.  A padding lane (``en``
    false) reports RUNNING; a lane that does not search keeps an all -1
    trace and 0 backtracks."""
    NV = pt.var_choices.shape[0]
    V, W = _phase_space(pt, red, NCON)
    S = _space(pt, red, block_rows, impl)
    pv_mask = torch.arange(V, device=pt.n_vars.device) < pt.n_vars
    pvb = _to_u(pack_mask(pv_mask, W))
    anchors = _anchor_mask(pt, V)
    base = _apply_anchors(pt, _phase_base(pt, red, V, NCON), V)
    t0 = _to_u(pack_mask(base == TRUE, W))
    f0 = _to_u(pack_mask(base == FALSE, W))
    zero = torch.zeros_like(t0)
    conflict0, t0, f0 = _fixpoint_u(S, t0, f0, zero, 0, en)
    outcome0 = test_outcome(conflict0, t0, f0, pvb)
    need_search = en and outcome0 == RUNNING
    na = int((pt.anchors >= 0).sum())
    result, assumed, m_t, m_f, steps, tr_stack, tr_n = search(
        S, pvb, t0, f0, outcome0, budget, 1, pt.choice_cand.tolist(),
        pt.var_choices.tolist(), na, NV, need_search, T)
    if need_search:
        guessed = unpack_mask(_to_i32(assumed), NV)
        model = planes_to_assign(_to_i32(m_t), _to_i32(m_f), NV)
    else:
        result = outcome0
        guessed = anchors[:NV]
        model = planes_to_assign(_to_i32(t0), _to_i32(f0), NV)
    if not en:
        result = RUNNING
    return result, guessed, model, steps, tr_stack, tr_n


def _to_space(x: torch.Tensor, V: int) -> torch.Tensor:
    """A [..., NV] phase-1 output widened to [..., V] with zeros: the
    full space's tail past the problem variables is never guessed,
    extra or excluded (core.py:1469-1477)."""
    return torch.nn.functional.pad(x, (0, V - x.shape[-1]))


def minimize_phase(pt: ProblemTensors, model: torch.Tensor,
                   guessed: torch.Tensor, budget: int, steps: int,
                   en: bool = True, *, red: bool = True,
                   NCON: Optional[int] = None, block_rows: int = 0,
                   impl: str = "bits"):
    """Phase 2 (core.py:1447-1535): the least w such that at most w
    extras (installed, not guessed) stay installed, by binary search over
    [0, n_extras] with one DPLL per probe, then one more probe at the
    minimal w when the last SAT probe was elsewhere.  ``red``, ``NCON``,
    ``block_rows`` and ``impl`` as in :func:`search_phase`; ``model`` and
    ``guessed`` are its [NV] outputs.  Returns (installed bool[NV], found,
    steps)."""
    NV = pt.var_choices.shape[0]
    V, W = _phase_space(pt, red, NCON)
    S = _space(pt, red, block_rows, impl)
    model = _to_space(model, V)
    guessed = _to_space(guessed, V)
    pv_mask = torch.arange(V, device=model.device) < pt.n_vars
    extras = (model == TRUE) & ~guessed & pv_mask
    excluded = (model != TRUE) & ~guessed & pv_mask
    m_init = _apply_anchors(pt, _phase_base(pt, red, V, NCON), V)
    m_init = torch.where(guessed, TRUE, m_init)
    m_init = torch.where(excluded, FALSE, m_init)
    n_extras = int(extras.sum()) if en else 0
    m_init_t = _to_u(pack_mask(m_init == TRUE, W))
    m_init_f = _to_u(pack_mask(m_init == FALSE, W))
    extras_bits = _to_u(pack_mask(extras, W))
    pvb = _to_u(pack_mask(pv_mask, W))
    lo, hi, best_w, found = 0, n_extras, -1, False
    m2_t = _to_u(pack_mask(model == TRUE, W))
    while en and lo < hi and steps <= budget:
        w = (lo + hi) // 2
        status, mt, _, steps = dpll(S, pvb, m_init_t, m_init_f, extras_bits,
                                    w, budget, steps, NV, en)
        if status == SAT:
            best_w, m2_t, found, hi = w, mt, True, w
        elif status == UNSAT:
            lo = w + 1
        else:
            lo = hi
    need_final = en and best_w != hi and n_extras > 0
    f_status, f_t, _, steps = dpll(S, pvb, m_init_t, m_init_f, extras_bits,
                                   hi, budget, steps, NV, need_final)
    if need_final:
        found = f_status == SAT
        if found:
            m2_t = f_t
    found = bool(found or (en and n_extras == 0))
    installed = unpack_mask(_to_i32(m2_t), NV) & pv_mask[:NV]
    if not (found and en):
        installed = torch.zeros_like(installed)
    return installed, found, steps


def core_phase(pt: ProblemTensors, budget: int, steps: int,
               en: bool = True, *, NCON: int, block_rows: int = 0,
               impl: str = "bits"):
    """Phase 3 (core.py:1548-1621, full space): the deletion unsat core.
    Starting from every applied constraint active, drop each whose removal
    keeps the rest UNSAT; chunks of :data:`CORE_CHUNK` are probed whole
    first and member by member only when the chunk probe is SAT.  Returns
    (core bool[NCON], steps).  ``NCON`` is the batch's padded constraint
    count: the full space is ``V = NV + NCON`` variables; ``block_rows``
    and ``impl`` as in :class:`_Space`."""
    NV = pt.var_choices.shape[0]
    V, W = _phase_space(pt, False, NCON)
    S = _space(pt, False, block_rows, impl)
    n_cons = int(pt.n_cons)
    dev = pt.n_vars.device
    idx = torch.arange(NCON, device=dev)
    active = (idx < n_cons) & bool(en)
    G = min(CORE_CHUNK, max(NCON, 1))
    pvb = _to_u(pack_mask(torch.arange(V, device=dev) < pt.n_vars, W))
    zero = torch.zeros(W, dtype=_I64, device=dev)
    j, k, chunk_mode = 0, 0, True
    while en and j < n_cons and steps <= budget:
        if chunk_mode:
            trial = active & ~((idx >= j) & (idx < j + G))
        else:
            trial = active.clone()
            if j + k < n_cons:
                trial[j + k] = False
        init = _base_assignment(pt, V, NCON, act_enabled=trial)
        status, _, _, steps = dpll(S, pvb, _to_u(pack_mask(init == TRUE, W)),
                                   _to_u(pack_mask(init == FALSE, W)), zero,
                                   0, budget, steps, NV, True)
        unsat = status == UNSAT
        if unsat:
            active = trial
        k2 = 0 if chunk_mode else k + 1
        advance = (chunk_mode and unsat) or (
            not chunk_mode and (k2 >= G or j + k2 >= n_cons))
        if advance:
            j += G
            k2 = 0
        k, chunk_mode = k2, advance
    return active, steps

