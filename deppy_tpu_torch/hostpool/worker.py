"""Host-pool worker process: the loop, and the one lane-solve routine (copy of ``deppy_tpu/hostpool/worker.py``).

:func:`solve_lane` is the single implementation of "solve one lane on
the host engine and report the observables": the pool's worker processes
(:func:`worker_main`, served by :class:`deppy_tpu_torch.hostpool.pool.HostPool`)
run it over a pipe and the inline path
(:func:`deppy_tpu_torch.hostpool.pool.solve_inline`) runs the very same
function in-process, so pool-against-inline identity (models, unsat
cores, step counts) holds by construction.  :func:`count_lane` and
:func:`lane_answer` are the one accounting and the one decode of a lane,
shared by the scheduler's host drain, its racer and ``BatchResolver``'s
host batch.

The worker imports neither ``torch`` nor ``jax``: the host engine is
pure numpy, so a worker forked from the pool's forkserver (whose preload
is this module) never holds a CUDA context.  The reference's
``JAX_PLATFORMS`` pin has nothing to pin here.
"""

from __future__ import annotations

import os
import signal
import time
from typing import List, Optional, Sequence


class HostLaneResult:
    """One lane's host-engine observables.

    ``outcome`` is ``"sat"`` / ``"unsat"`` / ``"incomplete"``;
    ``installed_idx`` / ``core_idx`` are the installed-variable /
    active-constraint index lists the engine's model and
    ``NotSatisfiable`` core decode to (consumers rebuild their own
    vocabulary from the problem's ``variables`` / ``applied`` lists).
    ``degraded`` marks a lane whose deadline expired before its solve
    started (outcome ``"incomplete"``, zero steps) — distinct from
    budget exhaustion, which reports the engine's real step count.
    """

    __slots__ = ("outcome", "installed_idx", "core_idx", "steps",
                 "decisions", "propagation_rounds", "backtracks",
                 "wall_s", "degraded")

    def __init__(self, outcome: str, installed_idx: Sequence[int] = (),
                 core_idx: Sequence[int] = (), steps: int = 0,
                 decisions: int = 0, propagation_rounds: int = 0,
                 backtracks: int = 0, wall_s: float = 0.0,
                 degraded: bool = False):
        self.outcome = outcome
        self.installed_idx = list(installed_idx)
        self.core_idx = list(core_idx)
        self.steps = int(steps)
        self.decisions = int(decisions)
        self.propagation_rounds = int(propagation_rounds)
        self.backtracks = int(backtracks)
        self.wall_s = float(wall_s)
        self.degraded = bool(degraded)

    def key(self) -> tuple:
        """Comparable identity tuple (differential tests)."""
        return (self.outcome, tuple(self.installed_idx),
                tuple(self.core_idx), self.steps, self.decisions,
                self.propagation_rounds, self.backtracks, self.degraded)


def count_lane(rep, r: HostLaneResult) -> None:
    """Fold one lane's observables into a ``SolveReport``: its outcome
    and, unless a deadline degraded it, the engine's counters."""
    if r.degraded:
        rep.count_outcome("incomplete")
        return
    rep.count_outcome(r.outcome)
    rep.steps += r.steps
    rep.decisions += r.decisions
    rep.propagation_rounds += r.propagation_rounds
    rep.backtracks += r.backtracks


def lane_answer(problem, r: HostLaneResult):
    """The lane's answer in the resolvers' vocabulary: a solution dict
    (every entity id False, the installed ones True, as
    ``driver.decode_results`` renders a SAT lane), a ``NotSatisfiable``
    over the very constraints of ``problem.applied`` in its core, or
    ``Incomplete``."""
    from ..sat.errors import Incomplete, NotSatisfiable

    if r.outcome == "sat":
        solution = {v.identifier: False for v in problem.variables}
        for i in r.installed_idx:
            solution[problem.variables[i].identifier] = True
        return solution
    if r.outcome == "unsat":
        return NotSatisfiable([problem.applied[j] for j in r.core_idx])
    return Incomplete()


def _degraded_result() -> HostLaneResult:
    return HostLaneResult("incomplete", degraded=True)


def solve_lane(problem, max_steps: Optional[int] = None,
               deadline=None, cancel=None) -> HostLaneResult:
    """Solve one lowered problem on the host spec engine.

    ``deadline`` is any object with ``expired()`` (a
    ``faults.Deadline``): expiry before the solve starts degrades the
    lane — admission control, never mid-solve preemption.

    ``cancel`` is a cooperative stop flag: the engine checks it at step
    boundaries and raises :class:`~deppy_tpu_torch.sat.host.SolveCancelled`,
    which propagates (a cancelled lane has no answer to report).

    ``InternalSolverError`` (malformed problem, minimization failure)
    propagates: the host engine is the last line of defense and masking
    its faults would return wrong answers.
    """
    from ..sat.errors import Incomplete, NotSatisfiable
    from ..sat.host import HostEngine

    if deadline is not None and deadline.expired():
        return _degraded_result()
    eng = HostEngine(problem, max_steps=max_steps, cancel=cancel)
    t0 = time.perf_counter()
    outcome = "incomplete"
    installed_idx: List[int] = []
    core_idx: List[int] = []
    try:
        _, installed_idx = eng.solve()
        # solve() returns (variables, indices); keep the indices.
        installed_idx = list(installed_idx)
        outcome = "sat"
    except NotSatisfiable as e:
        # solve() already ran the deletion sweep; the exception carries
        # the very objects of problem.applied, so the index list
        # rebuilds by identity — re-running unsat_core_mask would double
        # the step charge and could flip an in-budget UNSAT to
        # Incomplete.
        ids = {id(c) for c in e.constraints}
        core_idx = [j for j, c in enumerate(problem.applied)
                    if id(c) in ids]
        outcome = "unsat"
    except Incomplete:
        outcome = "incomplete"
    return HostLaneResult(
        outcome, installed_idx, core_idx, eng.steps, eng.decisions,
        eng.propagation_rounds, eng.backtracks,
        time.perf_counter() - t0,
    )


class _WireDeadline:
    """Deadline reconstructed from remaining-seconds at send time.

    Monotonic clocks don't transfer between processes; the remaining
    budget does.  Pipe latency slightly loosens the budget — the safe
    direction (a lane is never degraded earlier than inline would)."""

    __slots__ = ("_expires",)

    def __init__(self, remaining_s: float):
        self._expires = time.monotonic() + remaining_s

    def expired(self) -> bool:
        return time.monotonic() >= self._expires


# Exit code a worker uses for a scripted crash (the parent's
# ``hostpool.worker_crash`` fault point): distinguishable in logs from a
# real segfault, handled identically by the crash-retry path.
CRASH_EXIT_CODE = 70


def worker_main(conn, worker_id: int) -> None:
    """The worker process body: serve lane tasks off the duplex pipe
    until told to exit (or the pipe closes).

    Protocol (parent → worker): ``("task", seq, lanes, crash)`` where
    ``lanes`` is a CHUNK — a list of payload dicts with keys ``problem``
    / ``max_steps`` / ``deadline_s`` (remaining seconds or None) — and
    ``crash`` scripts a mid-task death (the ``hostpool.worker_crash``
    fault point); ``("exit",)``.  Chunking amortizes the pipe round trip
    over several ~ms solves.  Worker → parent: ``("ready", pid)`` once
    at startup, then ``("result", seq, out)`` with one entry per lane —
    a :class:`HostLaneResult`, or ``("err", messages)`` when the engine
    itself failed on that lane (the parent re-solves it inline so the
    real exception surfaces loud and typed).  Deadlines are re-checked
    per lane just before each solve, so an expiry mid-chunk degrades
    only the lanes not yet started."""
    # The parent owns interrupt handling; a Ctrl-C must drain through
    # the pool's graceful shutdown, not kill workers mid-solve.
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return  # parent died or closed the pipe: exit quietly
        if msg[0] == "exit":
            return
        _, seq, lanes, crash = msg
        if crash:
            # Scripted worker death (fault injection), mid-task so the
            # parent sees a busy worker's sentinel fire — the exact
            # shape of a real crash.
            os._exit(CRASH_EXIT_CODE)
        out = []
        for payload in lanes:
            deadline = None
            if payload.get("deadline_s") is not None:
                deadline = _WireDeadline(payload["deadline_s"])
            try:
                out.append(solve_lane(payload["problem"],
                                      max_steps=payload.get("max_steps"),
                                      deadline=deadline))
            except Exception as e:  # noqa: BLE001 — parent re-raises inline
                out.append(("err", [f"{type(e).__name__}: {e}"]))
        try:
            conn.send(("result", seq, out))
        except (OSError, ValueError):
            return
