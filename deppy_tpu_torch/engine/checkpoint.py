"""Group-wise checkpoint and resume for fleet-scale batch solves (copy of ``deppy_tpu/engine/checkpoint.py:1-180``).

A process that dies in the middle of a 10k-problem batch should not void
the groups it already solved.  This module checkpoints at the boundary
the chunked driver already has: groups of ``group`` problems.  Each
completed group's results are written to ``<dir>/group_<i>.npz`` beside
a fingerprint of the problem batch (``batch.json``); re-running the same
batch with the same directory loads the completed groups and solves only
the rest.  The fingerprint covers every problem's lowered tensors and
the step budget, so a changed batch never resumes from stale results
(the directory is then ignored for reading and rewritten).

Results round-trip exactly: each :class:`core.SolveResult` field is
stacked per group as a numpy array on save (the tensors copied to the
host) and unstacked into the port's types on load (ints and CPU
tensors).  The fault point ``checkpoint.save_group`` fires before each
write.  The reference's ``mesh=`` waits for ROADMAP A6.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zipfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..sat.encode import Problem
from . import core, driver

# The SolveResult fields held as ints in the port; the rest are tensors.
_INT_FIELDS = ("outcome", "steps", "trace_n")


def batch_fingerprint(problems: Sequence[Problem]) -> str:
    """Stable content hash of a lowered problem batch (order-sensitive);
    the reference's hash of the same variables."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(len(problems)).encode())
    for p in problems:
        for a in (p.clauses, p.card_ids, p.card_n, p.card_act, p.anchors,
                  p.choice_cand, p.var_choices):
            # Shape and dtype delimit each array: identical bytes under a
            # different padding must not collide, and neither may
            # adjacent arrays' concatenation.
            h.update(repr((a.shape, str(a.dtype))).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.int64([p.n_vars, p.n_cons]).tobytes())
    return h.hexdigest()


def _meta_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "batch.json")


def _group_path(ckpt_dir: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"group_{i:05d}.npz")


def _pad_to(a: np.ndarray, shape: tuple) -> np.ndarray:
    """Zero-pad ``a`` up to ``shape`` (same rank).  Decode reads masks by
    live index (< n_vars / n_cons), so zero padding is outcome-neutral."""
    if a.shape == shape:
        return a
    out = np.zeros(shape, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save_group(ckpt_dir: str, i: int,
                results: List[core.SolveResult]) -> None:
    # The fault point: a scripted crash here models the process dying
    # between completed groups.
    faults.inject("checkpoint.save_group")
    arrays = {}
    for f in core.SolveResult._fields:
        vals = [_host(getattr(r, f)) for r in results]
        # A group's results normally share their bucket's padded dims,
        # but the fault envelope can split a failing group or route part
        # of it to the host engine, leaving mixed widths: pad to the
        # widest so the stack (and the resume load) stays exact.
        widest = tuple(max(v.shape[k] for v in vals)
                       for k in range(vals[0].ndim))
        arrays[f] = np.stack([_pad_to(v, widest) for v in vals])
    tmp = _group_path(ckpt_dir, i) + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())  # data on disk before the rename points at it
    os.replace(tmp, _group_path(ckpt_dir, i))


def _load_group(ckpt_dir: str, i: int,
                n: int) -> Optional[List[core.SolveResult]]:
    path = _group_path(ckpt_dir, i)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {f: z[f] for f in core.SolveResult._fields}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # torn or stale file: recompute the group
    if arrays["outcome"].shape[0] != n:
        return None
    return [
        core.SolveResult(*[
            int(arrays[f][j]) if f in _INT_FIELDS
            else torch.from_numpy(np.ascontiguousarray(arrays[f][j]))
            for f in core.SolveResult._fields])
        for j in range(n)
    ]


def solve_problems_checkpointed(
    problems: Sequence[Problem],
    ckpt_dir: str,
    group: int = 0,
    max_steps: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> List[core.SolveResult]:
    """:func:`deppy_tpu_torch.engine.driver.solve_problems` with
    group-wise resume.  ``group`` = problems per checkpoint unit
    (default: the driver's per-dispatch lane cap, so one group is about
    one device dispatch).

    Semantics match ``solve_problems`` exactly — per-problem results in
    input order; groups are solved independently.  A group solved after
    the batch deadline expired may be deadline-degraded and is never
    persisted."""
    if mesh is not None:
        raise NotImplementedError(
            "solve_problems_checkpointed(mesh=...) is not ported yet: "
            "ROADMAP A6 (mesh serving)")
    if group <= 0:
        group = driver.MAX_LANES
    os.makedirs(ckpt_dir, exist_ok=True)
    fp = batch_fingerprint(problems)
    # max_steps is part of the key: results computed under a different
    # step budget (e.g. Incomplete at a tiny cap) must not resume.
    meta = {"fingerprint": fp, "n": len(problems), "group": group,
            "max_steps": max_steps}
    meta_ok = False
    try:
        with open(_meta_path(ckpt_dir)) as fh:
            meta_ok = json.load(fh) == meta
    except (OSError, ValueError):
        pass
    if not meta_ok:
        # A different batch (or a fresh directory): drop stale groups,
        # write the meta.
        for name in os.listdir(ckpt_dir):
            if name.startswith("group_") and name.endswith(".npz"):
                os.unlink(os.path.join(ckpt_dir, name))
        tmp = _meta_path(ckpt_dir) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, _meta_path(ckpt_dir))

    out: List[Optional[core.SolveResult]] = [None] * len(problems)
    resumed = 0
    # The ambient deadline here too, so the persistence check below sees
    # the env-configured batch deadline, not only a caller's scope.
    with faults.ambient_deadline() as dl:
        for gi, lo in enumerate(range(0, len(problems), group)):
            chunk = list(problems[lo: lo + group])
            cached = (_load_group(ckpt_dir, gi, len(chunk))
                      if meta_ok else None)
            if cached is None:
                cached = driver.solve_problems(chunk, max_steps=max_steps,
                                               device=device)
                if dl is None or not dl.expired():
                    _save_group(ckpt_dir, gi, cached)
            else:
                resumed += len(chunk)
            out[lo: lo + len(chunk)] = cached
    if resumed:
        print(f"[checkpoint] resumed {resumed}/{len(problems)} problems "
              f"from {ckpt_dir}", file=sys.stderr)
    return out  # type: ignore[return-value]
