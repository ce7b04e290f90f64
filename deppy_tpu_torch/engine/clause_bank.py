"""The watched clause bank and its implication-driven fixpoint, plain version (port of ``deppy_tpu/engine/clause_bank.py:84-377``).

The bank is the literal→clause adjacency of a problem: ``occ_pos`` /
``occ_neg`` ``[V, O]`` list the clause rows holding +v / -v (-1 padded),
``card_occ`` ``[NV, Oc]`` the AtMost rows each member variable sits in.
``O`` is the batch's largest literal occurrence bucketed to a power of
two and capped per size class (``driver._bank_cap``); a batch past its
cap gets 1-row dummy banks (:func:`bank_ready` is False) and the watched
impl runs the dense rounds instead, as in the reference.

* :func:`max_occurrence`, :func:`max_card_membership`,
  :func:`occ_from_clauses_np` and :func:`card_occ_np` build banks with
  numpy, as the reference's single-problem path does;
* :func:`derive_banks` builds them for a batch with torch ops on the
  batch's device (a stable sort, ``searchsorted`` and a scatter that
  drops the sentinel group), byte for byte the numpy build;
* :func:`watched_fixpoint` is the plain version of the CUDA watched arm
  (``csrc/watched.cuh``): one dense entry round, then one pop of the
  lowest pending literal per Python loop trip, visiting only the
  adjacency rows of the polarity it falsified.  The phases' plain
  versions reach it through ``core._fixpoint_u``; on the card every
  fixpoint of the watched impl is the kernels' arm, never this.

BCP is monotone and confluent, so the fixpoint's conflict flag, and its
planes where there is no conflict, equal the dense rounds'.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import core

_I32 = torch.int32
_I64 = torch.int64

# Work of the plain watched fixpoint: its pops, the live occurrence rows
# they visited, the live literals of those rows, and the AtMost entries
# of its true pops.  A kernel's watched arm does the same work on the
# same inputs, so these count its work too.
plain_work = dict(pops=0, rows=0, lits=0, cards=0)


# --------------------------------------------------------------------------
# bank construction with numpy (clause_bank.py:84-142)


def max_occurrence(clauses: np.ndarray) -> int:
    """Max clause count any single literal occurs in (0 for an empty
    clause set): the live width the bank's ``O`` is bucketed from."""
    lits = clauses[clauses != 0]
    if lits.size == 0:
        return 0
    key = 2 * (np.abs(lits).astype(np.int64) - 1) + (lits < 0)
    return int(np.bincount(key).max())


def max_card_membership(card_ids: np.ndarray) -> int:
    """Max AtMost-row count any single member variable occurs in."""
    mem = card_ids[card_ids >= 0]
    if mem.size == 0:
        return 0
    return int(np.bincount(mem.astype(np.int64)).max())


def occ_from_clauses_np(clauses: np.ndarray, V: int, O: int,
                        n_vars: "int | None" = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Signed clause matrix [C, K] → (occ_pos, occ_neg) ``i32[V, O]``
    adjacency (-1 pad).  ``n_vars`` drops literals past it (the reduced
    space's constant-true activations, as ``pos_bits_r`` does)."""
    occ_pos = np.full((V, O), -1, np.int32)
    occ_neg = np.full((V, O), -1, np.int32)
    rows, cols = np.nonzero(clauses)
    lits = clauses[rows, cols]
    if n_vars is not None:
        keep = np.abs(lits) <= n_vars
        rows, lits = rows[keep], lits[keep]
    v = np.abs(lits).astype(np.int64) - 1
    neg = lits < 0
    order = np.lexsort((rows, neg, v))  # group by (v, sign), row-stable
    v, neg, rows = v[order], neg[order], rows[order]
    key = 2 * v + neg
    first = np.searchsorted(key, key, side="left")
    rank = np.arange(key.size) - first
    for plane, m in ((occ_pos, ~neg), (occ_neg, neg)):
        plane[v[m], rank[m]] = rows[m]
    return occ_pos, occ_neg


def card_occ_np(card_ids: np.ndarray, NV: int, Oc: int) -> np.ndarray:
    """Member index matrix [NA, M] (-1 pad) → ``i32[NV, Oc]`` member →
    AtMost-row adjacency (-1 pad)."""
    out = np.full((NV, Oc), -1, np.int32)
    rows, cols = np.nonzero(card_ids >= 0)
    mem = card_ids[rows, cols].astype(np.int64)
    order = np.lexsort((rows, mem))
    mem, rows = mem[order], rows[order]
    first = np.searchsorted(mem, mem, side="left")
    rank = np.arange(mem.size) - first
    out[mem, rank] = rows
    return out


# --------------------------------------------------------------------------
# bank construction on the batch's device (clause_bank.py:145-215)


def _grouped_scatter(keys: torch.Tensor, rows: torch.Tensor, n_keys: int,
                     O: int) -> torch.Tensor:
    """Grouped fill over a batch: for each lane and each key group
    (ascending), write its rows into ``out[b, key, 0..count-1]``.
    ``keys`` [B, N] int64 with ``n_keys`` the invalid sentinel (dropped,
    with any rank past ``O``, which only the sentinel group reaches: the
    driver sizes ``O`` from the batch's largest occurrence); ``rows``
    [N].  The sort is stable, so rows land in clause order, as in the
    numpy build.  Returns int32 [B, n_keys, O]."""
    B = keys.shape[0]
    order = torch.argsort(keys, dim=-1, stable=True)
    ks = torch.gather(keys, -1, order)
    rs = rows[order]
    first = torch.searchsorted(ks, ks, side="left")
    rank = torch.arange(ks.shape[-1], device=keys.device) - first
    out = torch.full((B, n_keys, O), -1, dtype=_I32, device=keys.device)
    keep = ks < n_keys
    lane = torch.arange(B, device=keys.device).unsqueeze(-1).expand_as(ks)
    out[lane[keep], ks[keep], rank[keep]] = rs[keep].to(_I32)
    return out


def derive_banks(clauses: torch.Tensor, card_ids: torch.Tensor,
                 n_vars: torch.Tensor, *, V: int, NV: int, Ob: int, Oc: int,
                 red: bool, full: bool = True) -> Tuple[torch.Tensor, ...]:
    """Batched bank build from the compact tensors, on their device:
    ``clauses`` [B, C, K], ``card_ids`` [B, NA, M], ``n_vars`` [B].
    Returns (occ_pos, occ_neg, occ_pos_r, occ_neg_r, card_occ); a space
    not asked for comes back as ``[B, 1, 1]`` dummies of -1, which
    :func:`bank_ready` refuses."""
    B, C, K = clauses.shape
    dev = clauses.device
    lit = clauses.reshape(B, C * K).to(_I64)
    rows = torch.arange(C * K, device=dev) // K

    def occ(width: int, drop_acts: bool):
        valid = lit != 0
        if drop_acts:
            valid = valid & (lit.abs() <= n_vars.to(_I64).unsqueeze(-1))
        key = torch.where(valid, (lit.abs() - 1) * 2 + (lit < 0), 2 * width)
        occ2 = _grouped_scatter(key, rows, 2 * width, Ob)
        return occ2[:, 0::2].contiguous(), occ2[:, 1::2].contiguous()

    def dummy():
        return torch.full((B, 1, 1), -1, dtype=_I32, device=dev)

    occ_pos, occ_neg = occ(V, False) if full else (dummy(), dummy())
    occ_pos_r, occ_neg_r = occ(NV, True) if red else (dummy(), dummy())
    mem = card_ids.reshape(B, -1).to(_I64)
    key = torch.where(mem >= 0, mem, NV)
    card_rows = torch.arange(mem.shape[1], device=dev) // card_ids.shape[-1]
    card_occ = _grouped_scatter(key, card_rows, NV, Oc)
    return occ_pos, occ_neg, occ_pos_r, occ_neg_r, card_occ


def bank_ready(occ: torch.Tensor) -> bool:
    """Whether ``occ`` is a real adjacency bank and not the 1-row dummy a
    batch past its occurrence cap (or an impl other than ``watched``)
    gets.  Every real bank has ``V >= 2`` rows (``NV >= 1`` and ``NCON
    >= 1``)."""
    return occ.shape[-2] > 1


# --------------------------------------------------------------------------
# the implication-driven fixpoint (clause_bank.py:226-377)


def _watched_u(clauses, n_vars: int, occ_pos, occ_neg, card_occ, pos, neg,
               mem, card_active, card_n, min_bits, min_w: int, t0, f0,
               run: bool, red: bool):
    """The watched fixpoint of one problem on unsigned words held in
    int64 (the domain of ``core._fixpoint_u``): ``pos``/``neg`` [C, W],
    ``mem`` [NA, W], ``card_active`` bool[NA], ``card_n`` int64[NA],
    ``min_bits``/``t0``/``f0`` [W]; ``clauses`` [C, K] and the bank int32.
    Returns (conflict: bool, t, f), the planes after the last pop (on a
    conflict too, as the reference's loop leaves them).

    One dense entry round settles every consequence of the entry state.
    Then each trip pops the lowest pending variable (a bit enters pending
    in the same update that sets it in t/f) and recomputes only the rows
    of ``occ_neg[v]`` (v went true) or ``occ_pos[v]`` (v went false) from
    the raw literals, per occurrence, dropping literals past ``n_vars``
    under ``red``; a true v also counts once per entry of ``card_occ[v]``
    in its AtMost rows and in the extras row.  The AtMost and extras
    counters start from the ENTRY state ``t0``: the entry round's fresh
    literals count when popped."""
    if not run:
        return False, t0, f0
    W = t0.shape[0]
    Vb = occ_pos.shape[0]
    NVb = card_occ.shape[0]
    c0, t, f, _ = core._round_u(pos, neg, mem, card_active, card_n,
                                min_bits, min_w, t0, f0)
    core.plain_rounds += 1
    conflict = bool(c0)
    pend_t = t & ~t0
    pend_f = f & ~f0
    trues = core._popcount_u(mem & t0).sum(-1)
    mtrues = int(core._popcount_u(min_bits & t0).sum())
    lits = clauses.to(_I64)
    live_all = lits != 0
    if red:
        live_all = live_all & (lits.abs() <= n_vars)
    # A literal that is not live reads as false; its variable (past the
    # reduced planes under ``red``) is never looked up.
    var_all = torch.where(live_all, lits.abs() - 1, 0)
    sign_all = torch.sign(lits)
    zero = torch.zeros_like(t0)

    def plane_of(vars_: torch.Tensor) -> torch.Tensor:
        """The unsigned plane [W] with the bits of ``vars_`` set."""
        mask = torch.zeros(W * core.WORD, dtype=torch.bool, device=t0.device)
        mask[vars_] = True
        return core._to_u(core.pack_mask(mask, W))

    while not conflict:
        p_any = (pend_t | pend_f).tolist()
        wi = next((i for i, w in enumerate(p_any) if w), -1)
        if wi < 0:
            break
        plain_work["pops"] += 1
        lsb = p_any[wi] & -p_any[wi]
        v = wi * core.WORD + lsb.bit_length() - 1
        is_true = bool(int(pend_t[wi]) & lsb)
        pend_t = pend_t.clone()
        pend_f = pend_f.clone()
        pend_t[wi] &= ~lsb
        pend_f[wi] &= ~lsb
        a_now = t | f
        add_t, add_f = zero, zero
        dead = False

        # The rows of the polarity v's value falsified.
        rows = (occ_neg if is_true else occ_pos)[min(max(v, 0), Vb - 1)]
        rows = rows[rows >= 0].long()
        plain_work["rows"] += rows.numel()
        if rows.numel():
            vv, ss, lv = var_all[rows], sign_all[rows], live_all[rows]
            plain_work["lits"] += int(lv.sum())
            tb = ((t[vv >> 5] >> (vv & 31)) & 1) != 0
            fb = ((f[vv >> 5] >> (vv & 31)) & 1) != 0
            val = ss * torch.where(tb, 1, torch.where(fb, -1, 0))
            val = torch.where(lv, val, core.FALSE)
            sat_c = (val == core.TRUE).any(1)
            n_un = (val == core.UNASSIGNED).sum(1)
            visited = lv.any(1)
            dead = bool((visited & ~sat_c & (n_un == 0)).any())
            unit = visited & ~sat_c & (n_un == 1)
            ucol = torch.argmax((val == core.UNASSIGNED).to(torch.int8), 1)
            uvar = vv.gather(1, ucol.unsqueeze(1))[:, 0]
            usign = ss.gather(1, ucol.unsqueeze(1))[:, 0]
            add_t = plane_of(uvar[unit & (usign > 0)])
            add_f = plane_of(uvar[unit & (usign < 0)])

        # AtMost rows: only a true v moves a row's count, once per entry.
        over = False
        if is_true and v < NVb:
            crows = card_occ[v]
            crows = crows[crows >= 0].long()
            plain_work["cards"] += crows.numel()
            if crows.numel():
                trues = trues.index_add(0, crows, torch.ones_like(crows))
                tr = trues[crows]
                act = card_active[crows]
                over = bool((act & (tr > card_n[crows])).any())
                full_r = act & (tr == card_n[crows])
                if bool(full_r.any()):
                    add_f = add_f | core._or_rows(mem[crows[full_r]] & ~a_now)

        # The dynamic "at most min_w of the extras" row.
        in_min = is_true and bool((int(min_bits[wi]) & lsb))
        mtrues += int(in_min)
        min_over = in_min and mtrues > min_w
        if in_min and mtrues == min_w:
            add_f = add_f | (min_bits & ~a_now)

        new_t = add_t & ~a_now
        new_f = add_f & ~a_now
        t = t | new_t
        f = f | new_f
        pend_t = pend_t | new_t
        pend_f = pend_f | new_f
        conflict = (dead or over or min_over
                    or bool(((t & f) != 0).any()))
    return conflict, t, f


def watched_fixpoint(clauses, n_vars, occ_pos, occ_neg, card_occ, pos, neg,
                     mem, card_active, card_n2, min_bits, min_w, t0, f0,
                     enabled, red: bool):
    """Propagate int32 planes ``(t0, f0)`` [W] of one problem to a
    fixpoint through the bank, with the reference's signature
    (clause_bank.py:226): ``clauses`` [C, K], ``occ_pos``/``occ_neg``
    [Vb, O], ``card_occ`` [NVb, Oc], dense ``pos``/``neg`` [C, W] and
    ``mem`` [NA, W] for the entry round, ``card_active`` bool[NA],
    ``card_n2`` [NA].  No entry-overlap check (``core.planes_fixpoint``
    adds it).  Returns (conflict: bool, t, f) int32."""
    c, t, f = _watched_u(
        clauses, int(n_vars), occ_pos, occ_neg, card_occ, core._to_u(pos),
        core._to_u(neg), core._to_u(mem), card_active.reshape(-1).bool(),
        card_n2.reshape(-1).to(_I64), core._to_u(min_bits), int(min_w),
        core._to_u(t0), core._to_u(f0), bool(enabled), red)
    return c, core._to_i32(t), core._to_i32(f)
