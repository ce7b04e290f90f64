"""The card's circuit breakers (copy of ``deppy_tpu/faults/breaker.py:1-366``).

Trip to host-only solving under repeated device failures, half-open on
a probe dispatch after a cooldown.  A card that starts failing (a
launch that returns a CUDA error, a wedged context) can take a long
time to come back, and every dispatch against it in that window would
burn its full retry budget before falling back.  The breaker turns that
per-dispatch penalty into a process-wide verdict:

  * **closed** — normal operation; every device failure the driver's
    recovery wrapper records counts toward ``failure_threshold``;
  * **open** — ``failure_threshold`` consecutive failures seen.  Device
    dispatch is denied outright (``allow()`` is False), the driver routes
    groups straight to the host engine, and ``auto`` backend resolution
    (:func:`deppy_tpu_torch.sat.solver.resolve_backend`) degrades to host
    without paying the probe;
  * **half-open** — ``reset_after_s`` after tripping, exactly one probe
    dispatch is let through.  Success closes the breaker; failure
    re-opens it for another cooldown.

State changes are exported on the telemetry registry
(``deppy_breaker_state`` gauge, ``deppy_breaker_transitions_total``
counter) and emitted as ``breaker`` events; a fresh closed→open trip
dumps the flight recorder (:func:`telemetry.trace.notify_breaker_open`).

The per-device fleet (breaker.py:287-366): the mesh's sharded dispatch
charges the breaker of the slot whose shard failed
(:func:`device_breaker`, keyed by the slot index), gated on the process
breaker (:class:`GatedDeviceBreaker`), so one bad slot host-routes only
its slice.  ``render_metric_lines`` is in the package's ``__init__``, as
in the reference.  The lock is a plain :class:`threading.Lock` until lockdep (A7.2).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# Gauge codes, chosen so "bigger = less healthy" for dashboards.
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2

_STATE_NAMES = {
    BREAKER_CLOSED: "closed",
    BREAKER_HALF_OPEN: "half_open",
    BREAKER_OPEN: "open",
}


class CircuitBreaker:
    """Thread-safe three-state breaker (closed → open → half-open).

    ``device`` labels a per-device breaker (one a mesh slot, so a single
    bad slot trips only its shard to the host).  ``None`` is the
    process-wide breaker; labelled breakers publish their transitions
    with a ``device`` field and leave the process-wide
    ``deppy_breaker_state`` gauge, the transitions counter and the
    flight-recorder dump alone (``faults.render_metric_lines`` renders
    their ``deppy_breaker_state{device=...}`` lines)."""

    def __init__(self, failure_threshold: int = 3,
                 reset_after_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 device: Optional[str] = None):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self.device = device
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    # ------------------------------------------------------------- queries

    def state(self) -> str:
        """Current state name; evaluates the cooldown (an open breaker
        whose cooldown elapsed reads ``half_open``)."""
        with self._lock:
            return _STATE_NAMES[self._state_locked()]

    def state_code(self) -> int:
        """Gauge value: 0 closed, 1 half-open, 2 open."""
        with self._lock:
            return self._state_locked()

    def blocks_device(self) -> bool:
        """True while device dispatch is denied (open, cooldown not yet
        elapsed).  Non-consuming — safe for routing decisions; the
        half-open probe slot is only claimed by :meth:`allow`."""
        with self._lock:
            return self._state_locked() == BREAKER_OPEN

    def remaining_s(self) -> float:
        """Cooldown seconds left before a half-open probe (0 when not
        open)."""
        with self._lock:
            if self._state != BREAKER_OPEN:
                return 0.0
            return max(self._opened_at + self.reset_after_s - self._clock(),
                       0.0)

    # ------------------------------------------------------------ verdicts

    def allow(self) -> bool:
        """May a device dispatch proceed?  In half-open state exactly one
        caller gets True (the probe); everyone else is denied until the
        probe resolves via record_success/record_failure."""
        with self._lock:
            state = self._state_locked()
            if state == BREAKER_CLOSED:
                return True
            if state == BREAKER_OPEN:
                return False
            # Half-open: claim the single probe slot.
            if self._probe_in_flight:
                return False
            ev = self._transition_locked(BREAKER_HALF_OPEN)
            self._probe_in_flight = True
        self._publish(ev)
        return True

    def record_success(self) -> None:
        """A device dispatch completed: reset the failure streak and
        close the breaker (a half-open probe succeeding is the recovery
        signal)."""
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            ev = self._transition_locked(BREAKER_CLOSED)
        self._publish(ev)

    def record_failure(self) -> bool:
        """A device dispatch failed; returns True when this failure trips
        (or re-trips) the breaker open."""
        ev = None
        tripped = False
        with self._lock:
            self._consecutive_failures += 1
            state = self._state_locked()
            if state == BREAKER_HALF_OPEN or self._probe_in_flight:
                # The probe failed: back to a fresh cooldown.
                self._probe_in_flight = False
                ev = self._open_locked()
                tripped = True
            elif (state == BREAKER_CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                ev = self._open_locked()
                tripped = True
        self._publish(ev)
        return tripped

    def abandon_probe(self) -> None:
        """Release a claimed half-open probe slot without a verdict —
        the dispatch exited for a non-device reason (a semantic outcome,
        a defect of the tree) before proving anything about the card.
        The next ``allow()`` may probe again; without this, a leaked
        slot would deny device dispatch forever.  No-op when no probe
        is in flight."""
        with self._lock:
            self._probe_in_flight = False

    def reset(self) -> None:
        """Force-close (tests; also the solver's successful re-probe —
        independent evidence the card recovered)."""
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            ev = self._transition_locked(BREAKER_CLOSED)
        self._publish(ev)

    # ------------------------------------------------------------ internal

    def _state_locked(self) -> int:
        """Current state with the open→half-open cooldown edge applied
        lazily (no background timer thread)."""
        if (self._state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.reset_after_s):
            return BREAKER_HALF_OPEN
        return self._state

    def _open_locked(self) -> "Optional[dict]":
        prev = self._state
        self._opened_at = self._clock()
        ev = self._transition_locked(BREAKER_OPEN)
        if ev is not None:
            ev["from"] = _STATE_NAMES[prev]
        return ev

    def _transition_locked(self, new_state: int) -> "Optional[dict]":
        """Mutate state only (caller holds the lock) and return the
        transition record for :meth:`_publish`, or None on no change.
        Telemetry happens OUTSIDE the breaker lock so slow sink I/O can
        never stall concurrent allow()/blocks_device() calls on the
        solve path."""
        if new_state == self._state:
            return None
        self._state = new_state
        return {"state": _STATE_NAMES[new_state], "code": new_state,
                "consecutive_failures": self._consecutive_failures}

    def _publish(self, ev: "Optional[dict]") -> None:
        """Export one transition (outside the lock): a ``breaker`` event,
        and for the process breaker the state gauge and the transitions
        counter; a fresh closed→open trip of the process breaker also
        dumps the flight recorder.  Half-open probe failures re-open
        without re-dumping: a card that stays down re-trips every
        cooldown.  A slot's breaker leaves the process-wide gauge and
        counter alone: one flapping slot is not the card cycling."""
        if ev is None:
            return
        from .. import telemetry
        from .metrics import BREAKER_STATE_HELP, fault_counter

        reg = telemetry.default_registry()
        if self.device is not None:
            reg.event("breaker", state=ev["state"], device=self.device,
                      consecutive_failures=ev["consecutive_failures"])
            return
        reg.gauge("deppy_breaker_state", BREAKER_STATE_HELP).set(ev["code"])
        reg.event("breaker", state=ev["state"],
                  consecutive_failures=ev["consecutive_failures"])
        fault_counter("deppy_breaker_transitions_total").inc(
            1, label=ev["state"])
        if ev["state"] == "open" and ev.get("from") == "closed":
            from ..telemetry.trace import notify_breaker_open

            notify_breaker_open()


_DEFAULT: Optional[CircuitBreaker] = None
_DEFAULT_LOCK = threading.Lock()


def _breaker_from_env() -> CircuitBreaker:
    from .policy import env_float

    return CircuitBreaker(
        failure_threshold=int(env_float("DEPPY_GPU_BREAKER_THRESHOLD", 3)),
        reset_after_s=env_float("DEPPY_GPU_BREAKER_RESET_S", 30.0),
    )


def default_breaker() -> CircuitBreaker:
    """The process-wide card breaker (one card, one breaker).
    Configured from ``DEPPY_GPU_BREAKER_THRESHOLD`` /
    ``DEPPY_GPU_BREAKER_RESET_S`` at first use."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = _breaker_from_env()
    return _DEFAULT


def set_default_breaker(
        breaker: Optional[CircuitBreaker]) -> Optional[CircuitBreaker]:
    """Swap the process breaker (tests); returns the previous one.
    ``None`` re-creates from the environment at next use."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, breaker
    return prev


# --------------------------------------------------------- per-device fleet
#
# The mesh's sharded dispatch charges failures to the breaker of the SLOT
# whose shard failed, so one bad slot degrades only its slice of the
# serving mesh; batchmates on healthy slots keep dispatching.  The
# process-wide breaker above stays the whole-card verdict (the driver's
# non-sharded paths keep charging it).

_DEVICE_BREAKERS: "dict[str, CircuitBreaker]" = {}
_DEVICE_LOCK = threading.Lock()


def device_breaker(device: object) -> CircuitBreaker:
    """The breaker for one mesh slot, keyed by ``str(device)`` (the
    driver passes the slot index, the keys the reference's virtual
    devices give); created from the same ``DEPPY_GPU_BREAKER_*`` knobs
    as the process breaker on first use."""
    key = str(device)
    with _DEVICE_LOCK:
        br = _DEVICE_BREAKERS.get(key)
        if br is None:
            br = _breaker_from_env()
            br.device = key
            _DEVICE_BREAKERS[key] = br
    return br


def device_breakers() -> "dict[str, CircuitBreaker]":
    """Snapshot of the per-device breaker fleet (metrics rendering)."""
    with _DEVICE_LOCK:
        return dict(_DEVICE_BREAKERS)


def reset_device_breakers() -> None:
    """Drop every per-device breaker (tests; also after a mesh
    reconfiguration, where stale keys would render forever)."""
    with _DEVICE_LOCK:
        _DEVICE_BREAKERS.clear()


class GatedDeviceBreaker:
    """A slot's breaker that ALSO honours the process-wide breaker
    (breaker.py:331-366): an OPEN process breaker host-routes every shard
    without paying an attempt, as it does every non-sharded dispatch.
    Verdicts charge only the slot's breaker: one shard's failure must not
    trip the process to host-only, and a shard success must not close (or
    consume the half-open probe slot of) the process breaker."""

    def __init__(self, device: CircuitBreaker, process: CircuitBreaker):
        self._device = device
        self._process = process

    def allow(self) -> bool:
        # blocks_device() is the non-consuming check: an open process
        # breaker denies the shard without claiming its probe slot.
        if self._process.blocks_device():
            return False
        return self._device.allow()

    def blocks_device(self) -> bool:
        return (self._process.blocks_device()
                or self._device.blocks_device())

    def state(self) -> str:
        """The effective (most-degraded) state, for fault events (the
        names order as the states degrade: closed < half_open < open)."""
        return max(self._process.state(), self._device.state())

    def record_success(self) -> None:
        self._device.record_success()

    def record_failure(self) -> bool:
        return self._device.record_failure()

    def abandon_probe(self) -> None:
        self._device.abandon_probe()
