"""Gradient-guided continuous-relaxation entrant (port of ``deppy_tpu/engine/grad_relax.py:1-178``).

Relax each boolean variable to a probability, descend a differentiable
clause-satisfaction loss, round the minimum back to an assignment, and
let a discrete engine keep the correctness contract.  This module is
that entrant, shaped for the portfolio racer:

  * :func:`candidate_models` — one batched sigmoid-relaxation descent
    over the batch's compact clause tensors (:func:`driver.pad_stack`'s
    fields, the reference's ``pack=False`` ones), in torch on the
    caller's device.  Loss per lane: product-form clause
    unsatisfaction ``Π(1 - s_k)`` over literal satisfaction
    probabilities, a squared hinge on each AtMost bound, and a pull
    toward TRUE on anchors.  Deterministic: zero-logit init, a fixed
    step count, and a gradient whose scatter into the variables is an
    exact integer sum (:func:`_segment_sum`), so two runs on the card
    agree bit for bit although CUDA's float atomics do not.
  * :func:`attempt` / :func:`solve_lanes` — the certification leg: each
    rounded candidate goes through
    :meth:`deppy_tpu_torch.sat.host.HostEngine.solve_guided`, which
    serves an answer ONLY when it is provably byte-identical to the
    canonical solve and raises otherwise.  Unverified roundings are
    never served — the lane comes back None and the racing discrete
    engines own the verdict.

The reference runs the descent as one jitted, vmapped ``jax.grad``
program; it is plain JAX there, not a Pallas kernel, so the port runs it
as torch ops (autograd for the loss's elementwise part) and has no CUDA
kernel for it.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..hostpool.worker import HostLaneResult, _degraded_result
from ..sat.errors import Incomplete
from ..sat.host import GuidanceUnverified, HostEngine

# Descent schedule: fixed iteration count and learning rate (no
# stochasticity — restarts or noise would break race reproducibility and
# buy little: the certification leg, not the descent, owns
# correctness).  Module constants, not knobs: the descent is a screen
# whose output is verified, so tuning it can only shift which lanes take
# the fast path, never what is served.
DESCENT_ITERS = 48
DESCENT_LR = 0.8

# Fixed-point scale of the gradient's scatter: each contribution is
# rounded to a multiple of 2**-40 and summed as int64, which no order of
# atomic adds can change.  Contributions of magnitude >= 2**-17 are
# exact; the rest move by at most 2**-41 each.
_FIXED_SCALE = float(2 ** 40)


def _segment_sum(values: torch.Tensor, index: torch.Tensor,
                 NV: int) -> torch.Tensor:
    """float32[B, NV]: ``values`` [B, L] summed into the variables
    ``index`` [B, L] names, lane by lane, in fixed point (exact and
    order-free on every device)."""
    B = values.shape[0]
    q = torch.round(values.double() * _FIXED_SCALE).to(torch.int64)
    flat = (index.long() + torch.arange(B, device=index.device)
            .unsqueeze(1) * NV).reshape(-1)
    out = torch.zeros(B * NV, dtype=torch.int64, device=values.device)
    out.index_add_(0, flat, q.reshape(-1))
    return (out.double() / _FIXED_SCALE).float().view(B, NV)


def _descend(clauses: torch.Tensor, card_ids: torch.Tensor,
             card_n: torch.Tensor, card_valid: torch.Tensor,
             anchors: torch.Tensor, n_vars: torch.Tensor, NV: int,
             iters: int) -> torch.Tensor:
    """The relaxation descent over a padded batch on its device
    (``grad_relax.py:57-106``); returns the final logits float32[B, NV].

    The loss is the reference's, per lane.  Its gradient with respect to
    each gathered probability comes from autograd (elementwise ops and
    per-row reductions), and the gathers' backward — a scatter into the
    variables — is :func:`_segment_sum`."""
    B = clauses.shape[0]
    var = clauses.abs().long() - 1                        # [B, C, K]
    pv = var.clamp(0, NV - 1)
    is_act = var >= n_vars.long().view(B, 1, 1)            # activation lits
    pad = clauses == 0
    positive = clauses > 0
    mmask = card_ids >= 0
    mv = card_ids.long().clamp(0, NV - 1)
    amask = anchors >= 0
    av = anchors.long().clamp(0, NV - 1)
    valid_row = (~pad).any(dim=2)
    card_on = card_valid > 0
    card_n = card_n.float()

    def loss(pe, pm, pa):
        # Literal satisfaction probability; activation variables read
        # constant TRUE (the solve's base assumption), pad cells
        # contribute nothing to their clause's product.
        p_eff = torch.where(is_act, torch.ones_like(pe), pe)
        s = torch.where(positive, p_eff, 1.0 - p_eff)
        un = torch.where(pad, torch.ones_like(s), 1.0 - s)
        cl = torch.prod(un, dim=2)
        total = torch.where(valid_row, cl, torch.zeros_like(cl)).sum()
        # AtMost rows: squared hinge over the expected true count.
        mp = torch.where(mmask, pm, torch.zeros_like(pm))
        over = torch.clamp(mp.sum(dim=2) - card_n, min=0.0)
        total = total + torch.where(card_on, over * over,
                                    torch.zeros_like(over)).sum()
        # Anchors are assumed TRUE by every solve — pull them up.
        return total + torch.where(amask, 1.0 - pa,
                                   torch.zeros_like(pa)).sum()

    x = torch.zeros((B, NV), dtype=torch.float32, device=clauses.device)
    for _ in range(iters):
        p = torch.sigmoid(x)
        pe = torch.gather(p, 1, pv.view(B, -1)).view(pv.shape)
        pm = torch.gather(p, 1, mv.view(B, -1)).view(mv.shape)
        pa = torch.gather(p, 1, av)
        leaves = [t.detach().requires_grad_() for t in (pe, pm, pa)]
        with torch.enable_grad():
            ge, gm, ga = torch.autograd.grad(loss(*leaves), leaves)
        gp = (_segment_sum(ge.view(B, -1), pv.view(B, -1), NV)
              + _segment_sum(gm.view(B, -1), mv.view(B, -1), NV)
              + _segment_sum(ga, av, NV))
        # d sigmoid / dx, as autograd's sigmoid backward computes it.
        x = x - DESCENT_LR * (gp * (1.0 - p) * p)
    return x


def candidate_logits(problems: Sequence, device="cuda") -> torch.Tensor:
    """The descent's final logits float32[len(problems), NV] on
    ``device`` (NV = the batch's padded var width)."""
    from . import driver

    dev = driver.resolve_device(device)
    n = len(problems)
    d = driver._Dims(problems, max(n, 1))
    pts = driver.pad_stack(problems, d, d.B)
    fields = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (pts.clauses, pts.card_ids, pts.card_n,
                        pts.card_valid, pts.anchors, pts.n_vars)]
    with torch.no_grad():
        x = _descend(*fields, NV=d.NV, iters=DESCENT_ITERS)
    return x[:n]


def candidate_models(problems: Sequence, device="cuda") -> np.ndarray:
    """Run the batched descent over ``problems`` on ``device``; returns
    the rounded candidates as bool[n, NV] (``grad_relax.py:109-126``).
    Pure heuristic output — nothing downstream may trust it without the
    certification leg."""
    x = candidate_logits(problems, device=device)
    live = (torch.arange(x.shape[1], device=x.device)
            < torch.tensor([p.n_vars for p in problems],
                           device=x.device).unsqueeze(1))
    return ((torch.sigmoid(x) > 0.5) & live).cpu().numpy()


def attempt(problem, model: Optional[np.ndarray],
            max_steps: Optional[int] = None, deadline=None,
            cancel=None) -> Optional[HostLaneResult]:
    """Certify-and-serve one lane (``grad_relax.py:129-154``).  Returns a
    :class:`~deppy_tpu_torch.hostpool.worker.HostLaneResult` when the
    guided solve certified byte-identity to the canonical engine, None
    when it could not (the caller's discrete engines own the verdict).
    ``cancel`` is the race's cooperative stop flag;
    :class:`~deppy_tpu_torch.sat.host.SolveCancelled` propagates to the
    racer."""
    if deadline is not None and deadline.expired():
        return _degraded_result()
    eng = HostEngine(problem, max_steps=max_steps, cancel=cancel)
    t0 = time.perf_counter()
    try:
        _, installed_idx = eng.solve_guided(model)
    except GuidanceUnverified:
        return None
    except Incomplete:
        # Budget exhausted mid-certification: the discrete engines own
        # the Incomplete call (their step accounting is the canon).
        return None
    return HostLaneResult(
        "sat", installed_idx, (), eng.steps, eng.decisions,
        eng.propagation_rounds, eng.backtracks,
        time.perf_counter() - t0)


def solve_lanes(problems: Sequence,
                max_steps: Optional[int] = None,
                deadlines: Optional[Sequence] = None,
                cancel=None, device="cuda") -> List[Optional[HostLaneResult]]:
    """The racer's entrant entry (``grad_relax.py:157-178``): one
    batched descent on ``device``, then per-lane certification on the
    host.  Lanes come back None when unverified — a partial result set,
    which the racer treats as non-definitive."""
    from ..sat.host import SolveCancelled

    n = len(problems)
    dls = list(deadlines) if deadlines is not None else [None] * n
    per_lane_steps = (list(max_steps)
                      if isinstance(max_steps, (list, tuple))
                      else [max_steps] * n)
    if cancel is not None and cancel.is_set():
        raise SolveCancelled()
    models = candidate_models(problems, device=device)
    out: List[Optional[HostLaneResult]] = []
    for p, m, ms, dl in zip(problems, models, per_lane_steps, dls):
        out.append(attempt(p, m[: p.n_vars], max_steps=ms, deadline=dl,
                           cancel=cancel))
    return out
