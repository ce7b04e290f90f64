"""Batched BCP fixpoint: CUDA kernel wrapper and plain version (port of ``deppy_tpu/engine/pallas_bcp.py:79-110``).

:func:`bcp_fixpoint` takes a batch of problems' planes and runs the
propagation round to a fixpoint for each.  A CUDA tensor goes to the
hand-written kernel ``csrc/bcp.cu``; a CPU tensor goes to
:func:`bcp_fixpoint_plain`, the same computation one problem at a time in
PyTorch.  Like the Pallas kernel it has no entry-overlap check; its caller
adds it (``cuda_search``'s baseline fixpoint), as ``core.planes_fixpoint``
does around ``pallas_bcp.bcp_fixpoint``.

The fixpoint is the dense rounds, or, given an :class:`Arm`, the watched
arm (the implication-driven fixpoint over the problem's clause bank) or
the gather rounds over the raw rows (``csrc/watched.cuh``), which read no
dense plane on the card.  Every block kernel of the phases takes the same
arms (``cuda_search``); :class:`ArmArgs` carries them to a launch.

The kernel has two teams, picked per launch from the impl and the shape
by the rule it shares with kernels 4 and 5 (:mod:`.teams`): the warp team
(``bcp_warp_kernel``, one warp per problem, ``teams.WARPS`` problems a
block) for the dense rounds on planes of at most 32 words whose slice
fits the per-problem budget, which is every launch of the bits path; the
block team (``bcp_kernel``, one thread block per problem) for the shapes
the rule refuses, such as the full-space planes of a big catalog, and
for every watched and gather launch.  Both compute the same function.

Each launch counts once in :mod:`.counts`, by impl, team and bank.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from . import core, counts, teams

THREADS = 128

# Threads of a block kernel under the watched and gather arms.
ARM_THREADS = 256

_ARM_CODES = {"watched": 1, "gather": 2}


class ArmArgs(ctypes.Structure):
    """``ArmArgs`` of ``csrc/fixpoint.cuh``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "clauses", "card_ids", "n_vars", "occ_pos", "occ_neg", "card_occ",
        "lits", "mlits")] + [(name, ctypes.c_int) for name in (
            "arm", "red", "Kr", "Mr", "Vb", "Ob", "NVb", "Oc", "K", "M",
            "lit_bytes")]


class Arm(NamedTuple):
    """The watched arm or the gather rounds of a launch on a batch.
    ``impl`` is ``"watched"`` (the bank ``occ_pos``/``occ_neg`` [B, Vb,
    Ob] and ``card_occ`` [B, NVb, Oc], the entry round's compact rows
    ``rows``, a ``cuda_blockwise.Compact``, and ``red``: the visits and
    those rows drop literals past ``n_vars``) or ``"gather"``.  Both read
    the raw rows ``clauses`` [B, C, Kr] and ``card_ids`` [B, NA, Mr] and
    ``n_vars`` [B]."""

    impl: str
    clauses: torch.Tensor
    card_ids: torch.Tensor
    n_vars: torch.Tensor
    occ_pos: Optional[torch.Tensor] = None
    occ_neg: Optional[torch.Tensor] = None
    card_occ: Optional[torch.Tensor] = None
    rows: Optional[object] = None
    red: bool = False

    def check(self, B: int, C: int, NA: int, W: int) -> torch.device:
        """Raise unless the arm's tensors fit a batch of ``B`` problems
        of ``C`` clause rows, ``NA`` AtMost rows and ``W`` plane words;
        returns their device."""
        if self.impl not in _ARM_CODES:
            raise ValueError(f"no arm for impl {self.impl!r}")
        tensors = dict(clauses=self.clauses, card_ids=self.card_ids,
                       n_vars=self.n_vars)
        shapes = dict(clauses=(B, C, self.clauses.shape[-1]),
                      card_ids=(B, NA, self.card_ids.shape[-1]),
                      n_vars=(B,))
        if self.impl == "watched":
            Vb, Ob = self.occ_pos.shape[1:]
            NVb, Oc = self.card_occ.shape[1:]
            if Vb < 2 or Vb > core.WORD * W or NVb > Vb:
                raise ValueError(f"a watched bank of {Vb} rows does not "
                                 f"fit planes of {W} words")
            tensors.update(occ_pos=self.occ_pos, occ_neg=self.occ_neg,
                           card_occ=self.card_occ)
            shapes.update(occ_pos=(B, Vb, Ob), occ_neg=(B, Vb, Ob),
                          card_occ=(B, NVb, Oc))
        dev = _check_args(tensors, shapes)
        if self.impl == "watched" and dev.type == "cuda":
            lits, mlits = self.rows.lits, self.rows.mlits
            if (tuple(lits.shape[:2]) != (B, C)
                    or tuple(mlits.shape[:2]) != (B, NA)
                    or lits.device != dev or mlits.device != dev):
                raise ValueError(f"the entry round's compact rows must be "
                                 f"[{B}, {C}, *] and [{B}, {NA}, *] on "
                                 f"{dev}")
        return dev

    def args(self) -> ArmArgs:
        """The launch's :class:`ArmArgs` (keep it alive for the call)."""
        a = ArmArgs(clauses=self.clauses.data_ptr(),
                    card_ids=self.card_ids.data_ptr(),
                    n_vars=self.n_vars.data_ptr(), arm=_ARM_CODES[self.impl],
                    red=int(self.red), Kr=self.clauses.shape[-1],
                    Mr=self.card_ids.shape[-1])
        if self.impl == "watched":
            a.occ_pos = self.occ_pos.data_ptr()
            a.occ_neg = self.occ_neg.data_ptr()
            a.card_occ = self.card_occ.data_ptr()
            a.Vb, a.Ob = self.occ_pos.shape[1:]
            a.NVb, a.Oc = self.card_occ.shape[1:]
            a.lits = self.rows.lits.data_ptr()
            a.mlits = self.rows.mlits.data_ptr()
            a.K = self.rows.lits.shape[-1]
            a.M = self.rows.mlits.shape[-1]
            a.lit_bytes = self.rows.lits.element_size()
        return a

    def lane(self, b: int, card_act: Optional[torch.Tensor] = None
             ) -> core.Arm:
        """Problem ``b``'s arm for the plain versions; ``card_act`` as in
        :class:`core.Arm` (None: the static activity of the space)."""
        if self.impl == "watched":
            return core.Arm("watched", self.clauses[b], self.card_ids[b],
                            None, int(self.n_vars[b]), self.occ_pos[b],
                            self.occ_neg[b], self.card_occ[b], self.red)
        return core.Arm("gather", self.clauses[b], self.card_ids[b],
                        card_act, int(self.n_vars[b]))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


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
                 f0, en, *, impl: str = "bits", arm: Optional[Arm] = None,
                 _team: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched fixpoint.  int32 inputs: pos/neg [B, C, W], mem [B, NA, W],
    card_active/card_n [B, NA], min_bits/t0/f0 [B, W], min_w/en [B].
    ``arm`` runs the watched arm or the gather rounds instead of the dense
    rounds; on the card those read no dense plane, so pos/neg/mem may be
    ``[B, rows, 1]`` placeholders there.  ``impl`` is the impl the launch
    runs under (the team rule's input and the counts' key; a watched
    launch without ``arm`` is one on dummy banks).  Returns (conflict
    int32[B], t, f int32[B, W]).  ``_team`` forces a team (measurement
    only, see :mod:`.teams`)."""
    B, W = t0.shape
    C = pos.shape[1]
    NA = mem.shape[1]
    chosen, _ = teams.plan("bcp", 0, C, NA, W, 0, 0, _team, impl)
    args = dict(pos=pos, neg=neg, mem=mem, card_active=card_active,
                card_n=card_n, min_bits=min_bits, min_w=min_w, t0=t0, f0=f0,
                en=en)
    shapes = dict(pos=(B, C, W), neg=(B, C, W), mem=(B, NA, W),
                  card_active=(B, NA), card_n=(B, NA), min_bits=(B, W),
                  min_w=(B,), t0=(B, W), f0=(B, W), en=(B,))
    if arm is not None:
        dev = arm.check(B, C, NA, W)
        if dev.type == "cuda" or arm.impl == "gather":
            # The card's arms and the plain gather rounds read no plane.
            shapes.update(pos=tuple(pos.shape), neg=tuple(neg.shape),
                          mem=tuple(mem.shape))
    dev = _check_args(args, shapes)
    if dev.type == "cpu":
        return bcp_fixpoint_plain(**args, arm=arm)
    lib = _build.load()
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    t = torch.empty((B, W), dtype=torch.int32, device=dev)
    f = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dense = arm is None
    ptrs = (_ptr(pos) if dense else None, _ptr(neg) if dense else None,
            _ptr(mem) if dense else None, card_active.data_ptr(),
            card_n.data_ptr(), min_bits.data_ptr(), min_w.data_ptr(),
            t0.data_ptr(), f0.data_ptr(), en.data_ptr(), conflict.data_ptr(),
            t.data_ptr(), f.data_ptr(), B, C, NA, W)
    if chosen == "warp":
        teams.check_slice(lib, "bcp", C, NA, W, 0, 0, False)
        rc = lib.deppy_bcp_warp(*ptrs, teams.WARPS, stream)
    else:
        a = None if arm is None else arm.args()
        rc = lib.deppy_bcp_fixpoint(
            *ptrs, THREADS if arm is None else ARM_THREADS,
            None if a is None else ctypes.addressof(a), stream)
    counts.count("bcp_fixpoint", impl, chosen, arm)
    _build.check(rc, f"bcp_fixpoint ({chosen} team, {impl})")
    return conflict, t, f


def bcp_fixpoint_plain(pos, neg, mem, card_active, card_n, min_bits, min_w,
                       t0, f0, en, arm: Optional[Arm] = None):
    """The plain version of :func:`bcp_fixpoint`, on any device; ``arm``
    as there, its AtMost activity the static ``card_active``."""
    B, W = t0.shape
    conflict = torch.zeros(B, dtype=torch.int32, device=t0.device)
    t = t0.clone()
    f = f0.clone()
    for b in range(B):
        S = core._Space(core._to_u(pos[b]), core._to_u(neg[b]),
                        core._to_u(mem[b]), card_n[b].to(torch.int64),
                        card_active[b] != 0, None,
                        arm=None if arm is None else arm.lane(b))
        c, tb, fb = core._fixpoint_u(S, core._to_u(t0[b]), core._to_u(f0[b]),
                                     core._to_u(min_bits[b]), int(min_w[b]),
                                     bool(en[b]), pre_check=False)
        conflict[b] = int(c)
        t[b] = core._to_i32(tb)
        f[b] = core._to_i32(fb)
    return conflict, t, f
