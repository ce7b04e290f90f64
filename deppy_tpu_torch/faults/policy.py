"""Retry/backoff policy and wall-clock deadlines (copy of ``deppy_tpu/faults/policy.py:1-210``).

  * :class:`RetryPolicy` (``policy.py:90-139``) — how many times a
    failed dispatch group is re-attempted, with exponential backoff and
    jitter between attempts, and whether a group that keeps failing is
    split in half (isolating a poison chunk) before falling back to the
    host engine.  The **chunk** deadline (``chunk_deadline_s``) bounds
    one dispatch attempt: an attempt that runs past it counts
    ``deppy_deadline_exceeded`` and charges the circuit breaker;
  * :class:`Deadline` — a monotonic wall-clock budget.  The **batch**
    deadline rides a thread-local scope (:func:`deadline_scope`) from
    the caller down through the scheduler and the driver without
    touching their signatures.

Nothing here sleeps or loops on its own.  The driver's recovery wrapper
(:func:`deppy_tpu_torch.engine.driver._recovering`) reads both, on every
dispatch; the request scheduler (:mod:`deppy_tpu_torch.sched`) degrades
an expired lane at triage and runs each dispatch under the loosest live
lane's scope.

The knobs are ``DEPPY_GPU_*`` (the reference's ``DEPPY_TPU_*`` names),
declared in :mod:`deppy_tpu_torch.config`: :func:`env_float` and
:func:`env_int` assert the declaration before they read.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Union


def env_float(name: str, default: Optional[float],
              warn: bool = False) -> Optional[float]:
    """Defensive float-env parsing for every fault-domain knob: a typo'd
    value degrades to the default — the fault layer must never be the
    thing that crashes a solve — with an optional stderr warning for
    operator-facing knobs.  ``DEPPY_GPU_*`` names resolve through the
    typed registry (policy.py:45-47): an undeclared knob raises at the
    read site instead of silently existing."""
    from .. import config

    raw = config.env_raw(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        if warn:
            print(f"[deppy] ignoring non-numeric {name}={raw!r}",
                  file=sys.stderr, flush=True)
        return default


def env_int(name: str, default: int, warn: bool = True) -> int:
    """:func:`env_float` truncated to an int: the scheduler's and the host
    pool's int knobs (the reference's ``_env_int``, scheduler.py:103-105
    and hostpool/pool.py:67-69).  ``1.5`` reads 1; a malformed value
    warns and reads ``default``."""
    v = env_float(name, float(default), warn=warn)
    return int(v if v is not None else default)


class DeadlineExceeded(Exception):
    """A request/batch deadline could not be met.

    Raised only at admission time (the request's deadline is already
    unmeetable).  Inside the solve path an expired deadline *degrades* —
    remaining problems come back ``Incomplete`` — rather than raising,
    so completed batchmates keep their answers."""


class Deadline:
    """Monotonic wall-clock budget.  Cheap value object: two floats."""

    __slots__ = ("seconds", "_expires", "_clock")

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic):
        self.seconds = float(seconds)
        self._clock = clock
        self._expires = clock() + self.seconds

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self._expires - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


@dataclass
class RetryPolicy:
    """How a failed device dispatch is retried before degrading.

    ``max_attempts`` counts total tries of one dispatch group (2 = one
    retry).  Backoff for attempt *k* (1-based failures) is
    ``base * multiplier**(k-1)`` clamped to ``max_backoff_s``, plus up
    to ``jitter`` of itself at random so workers retrying against a
    shared card do not synchronize.  ``split_failed_groups`` halves a
    group that exhausted its attempts (recursively, so a single poison
    problem isolates in log2 steps) before the host-engine fallback.
    ``chunk_deadline_s`` > 0 bounds one attempt's wall clock; 0
    disables.
    """

    max_attempts: int = 2
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    split_failed_groups: bool = True
    chunk_deadline_s: float = 0.0

    def backoff_s(self, attempt: int,
                  rng: Callable[[], float] = random.random) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        base = min(self.base_backoff_s * self.multiplier ** max(attempt - 1, 0),
                   self.max_backoff_s)
        return base * (1.0 + self.jitter * rng())

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Build the driver's policy from the environment
        (``DEPPY_GPU_FAULT_RETRIES``, ``DEPPY_GPU_FAULT_BACKOFF_S``,
        ``DEPPY_GPU_FAULT_BACKOFF_MAX_S``, ``DEPPY_GPU_CHUNK_DEADLINE_S``;
        malformed values degrade to the defaults, see :func:`env_float`)."""
        return cls(
            max_attempts=max(int(env_float(
                "DEPPY_GPU_FAULT_RETRIES", cls.max_attempts)), 1),
            base_backoff_s=max(env_float(
                "DEPPY_GPU_FAULT_BACKOFF_S", cls.base_backoff_s), 0.0),
            max_backoff_s=max(env_float(
                "DEPPY_GPU_FAULT_BACKOFF_MAX_S", cls.max_backoff_s), 0.0),
            chunk_deadline_s=max(env_float(
                "DEPPY_GPU_CHUNK_DEADLINE_S", 0.0), 0.0),
        )


# ------------------------------------------------------------- deadline scope
#
# The active batch deadline travels on a thread-local, like the active
# SolveReport (telemetry.report).

_TLS = threading.local()


def current_deadline() -> Optional[Deadline]:
    """The batch deadline active on this thread, if any."""
    return getattr(_TLS, "deadline", None)


@contextmanager
def deadline_scope(
    seconds: Optional[Union[float, Deadline]],
) -> Iterator[Optional[Deadline]]:
    """Make a batch deadline active for the enclosed solve.  ``None`` is
    a no-op scope.  Nested scopes keep whichever deadline expires first
    (an inner, looser deadline must not extend the request's).

    Accepts either seconds (a fresh :class:`Deadline` starts now) or an
    existing :class:`Deadline` — the request scheduler captures each
    request's deadline on its submitting thread and re-installs the SAME
    clock on the dispatch-loop thread, so coalescing never restarts a
    request's budget."""
    prev = current_deadline()
    if seconds is None:
        yield prev
        return
    dl = seconds if isinstance(seconds, Deadline) else Deadline(seconds)
    if prev is not None and prev.remaining() < dl.remaining():
        dl = prev
    _TLS.deadline = dl
    try:
        yield dl
    finally:
        _TLS.deadline = prev


@contextmanager
def ambient_deadline() -> Iterator[Optional[Deadline]]:
    """The entry-point scope: when no caller installed a batch deadline,
    apply ``DEPPY_GPU_BATCH_DEADLINE_S`` from the environment
    (unset/invalid/<=0 → no deadline)."""
    if current_deadline() is not None:
        yield current_deadline()
        return
    seconds = env_float("DEPPY_GPU_BATCH_DEADLINE_S", None, warn=True)
    if seconds is not None and seconds <= 0:
        seconds = None
    with deadline_scope(seconds) as dl:
        yield dl


def note_deadline_exceeded(where: str, n_problems: int = 0,
                           tenant: Optional[str] = None) -> None:
    """Count one deadline expiry (``deppy_deadline_exceeded``) and emit a
    ``fault`` event to the telemetry sink.  Under an active trace
    context the event is also stamped onto the request's span tree and
    marks the trace errored.  ``tenant`` (the scheduler's triage knows
    whose lane expired) rides the event; callers without tenant context
    emit the event without it."""
    from .. import telemetry
    from .metrics import fault_counter

    fault_counter("deppy_deadline_exceeded").inc()
    fields = {"where": where, "problems": n_problems}
    if tenant is not None:
        fields["tenant"] = tenant
    telemetry.default_registry().event(
        "fault", fault="deadline_exceeded", **fields)
