"""The per-dispatch trip ledger (copy of ``deppy_tpu/profile/ledger.py:1-313``).

Each sampled dispatch records:

  * **trips** — per chunk the largest lane step count, summed over the
    dispatch's chunks.  In the reference a chunk is one vmapped XLA
    program whose ``while_loop`` runs every lane for the slowest lane's
    count.  On the card each problem runs on its own warp or block, so
    lanes are not paid in lockstep; the trip count is still a launch's
    critical path, its longest lane.  The definitions are kept so that
    events compare field for field;
  * **lane work** — the per-lane iteration counts the engine reports
    (``SolveResult.steps``), summed over live lanes;
  * **straggler distribution** — p50/p99 lane work against the trips;
  * **pad/fill waste** — padded against live clause-matrix cells;
  * **backend attribution** — device / host / hostpool / warm wall
    clock and lane counts.

Arming and sampling come from ``DEPPY_GPU_PROFILE`` (``on``/``off``,
default off) and ``DEPPY_GPU_PROFILE_SAMPLE`` (a rate in (0, 1], default
1), or :func:`configure` and :func:`override`.  Disarmed, :func:`dispatch_t0`
is one cached bool check per dispatch, no event is emitted and no
metric family is registered.  Armed, each sampled dispatch costs a few
numpy reductions over its step array plus one sink event.

Every ledger read happens after the driver fetched the dispatch's
results to host numpy (the ``.cpu()`` copies it makes anyway): nothing
here reads a CUDA tensor or adds a synchronization.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np

from .. import config, telemetry

# The tenant every request without a tenant name accounts under
# (slo.py reads it too; declared here so ledger stays the leaf).
DEFAULT_TENANT = "default"

# Arming modes: "off" (default — zero events, zero families), "on".
# Sample rate in (0, 1]: fraction of dispatches profiled when armed
# (deterministic 1-in-round(1/rate) counter, not random, so tests and
# overhead bounds are reproducible).
DEFAULT_SAMPLE = 1.0

_LOCK = threading.Lock()
_ARMED: Optional[bool] = None          # None = resolve from env lazily
_INTERVAL: Optional[int] = None        # every Nth dispatch is sampled
# One counter PER CALL SITE (device / warm / host / hostpool): a single
# shared modulo counter phase-locks under periodic call patterns — an
# incremental-serving loop alternating warm-flush and device-dispatch
# gates would, at interval 2, sample only one of the two forever.
_COUNTERS: dict = {}


def _on(raw) -> bool:
    return str(raw).strip().lower() in ("on", "1", "true", "yes")


def _resolve_locked() -> None:
    """Fill whichever of the two settings is still unresolved from the
    environment — independently, so an explicit ``configure(mode=...)``
    with no explicit sample still gets the env/default interval (and
    vice versa)."""
    global _ARMED, _INTERVAL
    if _ARMED is None:
        _ARMED = _on(config.env_raw("DEPPY_GPU_PROFILE", "off") or "off")
    if _INTERVAL is None:
        _INTERVAL = _interval_of(_env_sample())


def _env_sample() -> float:
    return config.env_float("DEPPY_GPU_PROFILE_SAMPLE", DEFAULT_SAMPLE,
                            strict=False)


def _interval_of(rate: float) -> int:
    if not (rate > 0):
        return 0  # 0/negative rate: armed but sampling nothing
    return max(int(round(1.0 / min(rate, 1.0))), 1)


def configure(mode: Optional[str] = None,
              sample: Optional[float] = None) -> None:
    """Install explicit profiler settings.  ``None`` leaves that axis to
    env resolution (re-resolved on next use)."""
    global _ARMED, _INTERVAL
    with _LOCK:
        _ARMED = None if mode is None else _on(mode)
        _INTERVAL = None if sample is None else _interval_of(float(sample))
        if _ARMED is None or _INTERVAL is None:
            _resolve_locked()


def armed() -> bool:
    """Fast check: is the profiler collecting at all?"""
    if _ARMED is None:
        with _LOCK:
            _resolve_locked()
    return bool(_ARMED)


def sample_rate() -> float:
    """The effective sampling rate (0.0 when sampling is disabled)."""
    if _ARMED is None:
        with _LOCK:
            _resolve_locked()
    return 0.0 if not _INTERVAL else 1.0 / _INTERVAL


@contextmanager
def override(mode: str, sample: float = 1.0):
    """Scoped arming (tests, ``chip_smoke.py``): restores the previous
    resolution state on exit."""
    global _ARMED, _INTERVAL
    with _LOCK:
        _resolve_locked()
        prev = (_ARMED, _INTERVAL)
        _ARMED = _on(mode)
        _INTERVAL = _interval_of(float(sample))
    try:
        yield
    finally:
        with _LOCK:
            _ARMED, _INTERVAL = prev


def dispatch_t0(site: str = "device") -> Optional[float]:
    """Sampling gate, called once at the top of each dispatch impl:
    returns a ``perf_counter`` start time when THIS dispatch is
    sampled, else None.  ``site`` names the caller's backend class —
    each site gets its own deterministic 1-in-N counter, so sampling
    at one site never phase-locks against another's call cadence.
    Disarmed this is one cached bool check."""
    if not armed() or not _INTERVAL:
        return None
    counter = _COUNTERS.get(site)
    if counter is None:
        with _LOCK:
            counter = _COUNTERS.setdefault(site, itertools.count())
    if next(counter) % _INTERVAL:
        return None
    return time.perf_counter()


# ---------------------------------------------------------------- recording


def _percentile(sorted_vals: np.ndarray, q: float) -> int:
    """Nearest-rank percentile over a pre-sorted int array — the
    shared telemetry statistic, cast back to a Python int."""
    return int(telemetry.percentile(sorted_vals, q))


def record_device_dispatch(t0: float, *, steps: np.ndarray, live: int,
                           chunk: int, size_class: int, pad_cells: int,
                           live_cells: int, backend: str = "device",
                           size_class_name: Optional[str] = None) -> None:
    """Record one sampled device dispatch's trip ledger.

    ``steps`` is the dispatch's final per-lane iteration counts (host
    numpy, length = padded lane total), live lanes first; ``chunk`` is
    the launch width (lanes per chunk), so per-chunk trips are the max
    lane count within each chunk.  Updates the thread's active
    :class:`SolveReport` ledger fields, the ``deppy_profile_*`` families
    on the default registry, and emits one ``profile`` event (stamped
    onto the active trace when one exists)."""
    dur_s = time.perf_counter() - t0
    total = int(steps.shape[0])
    live = min(int(live), total)
    chunk = max(int(chunk), 1)
    steps64 = steps.astype(np.int64, copy=False)
    trips = 0
    trip_slots = 0
    p99_trips = 0
    for lo in range(0, total, chunk):
        sl = steps64[lo: lo + chunk]
        live_sl = sl[: max(min(live - lo, chunk), 0)]
        if live_sl.size == 0:
            continue  # an all-pad chunk never dispatches
        t = int(sl.max())
        trips += t
        trip_slots += t * int(sl.shape[0])
        p99_trips += _percentile(np.sort(live_sl), 99)
    live_steps = steps64[:live]
    lane_work = int(live_steps.sum())
    s = np.sort(live_steps)
    p50 = _percentile(s, 50)
    p99 = _percentile(s, 99)
    useful = lane_work / trip_slots if trip_slots else 0.0
    straggler = p99_trips / trips if trips else 0.0
    pad_waste = 1.0 - live_cells / pad_cells if pad_cells else 0.0

    rep = telemetry.current_report()
    if rep is not None:
        rep.record_ledger(trips=trips, trip_slots=trip_slots,
                          lane_steps=lane_work, p99_trips=p99_trips)
    reg = telemetry.default_registry()
    reg.counter("deppy_profile_dispatches_total",
                "Sampled dispatches recorded by the trip ledger.").inc()
    reg.counter("deppy_profile_trips_total",
                "Trips paid by sampled dispatches (max lane steps per "
                "chunk, summed).").inc(trips)
    reg.counter("deppy_profile_lane_steps_total",
                "Useful per-lane engine iterations in sampled "
                "dispatches.").inc(lane_work)
    reg.histogram(
        "deppy_profile_useful_work_ratio",
        "Useful lane steps / trip-lane slots per sampled dispatch (low "
        "= trips spent on padding and stragglers).",
        buckets=telemetry.RATIO_BUCKETS).observe(useful)
    reg.histogram(
        "deppy_profile_straggler_p99_ratio",
        "p99 lane work / batch trips per sampled dispatch (low = one "
        "straggler lane drives the whole batch's trip count).",
        buckets=telemetry.RATIO_BUCKETS).observe(straggler)
    reg.histogram(
        "deppy_profile_pad_waste_ratio",
        "Padded clause-cell waste per sampled dispatch.",
        buckets=telemetry.RATIO_BUCKETS).observe(pad_waste)
    _backend_counters(reg, backend, dur_s, live)
    fields = {}
    if size_class_name is not None:
        # The dispatch's ladder class (deppy_tpu_torch.size_classes):
        # keys the report's per-class table by name instead of the raw
        # bucketed cost.
        fields["size_class_name"] = size_class_name
    reg.event("profile", backend=backend, size_class=int(size_class),
              **fields,
              lanes=total, live=live, chunk=chunk, trips=trips,
              lane_steps=lane_work, lane_p50=p50, lane_p99=p99,
              useful_work_ratio=round(useful, 4),
              straggler_p99_ratio=round(straggler, 4),
              pad_waste_ratio=round(pad_waste, 4),
              pad_cells=int(pad_cells), live_cells=int(live_cells),
              solve_s=round(dur_s, 6))


def record_backend_flush(backend: str, lanes: int, lane_steps: int,
                         dur_s: float,
                         tenant: Optional[str] = None) -> None:
    """Cost attribution for a flush without launches to count trips in
    (host / hostpool / warm): wall clock and lane count per backend,
    plus one ``profile`` event with no trip fields.  Callers gate on
    :func:`dispatch_t0` so sampling and arming match the device ledger.
    ``tenant``: set only when every lane in the flush belongs to one
    tenant (the scheduler knows); a mixed-tenant flush stays unstamped
    rather than misattributed."""
    reg = telemetry.default_registry()
    _backend_counters(reg, backend, dur_s, lanes)
    fields = {"backend": backend, "lanes": int(lanes),
              "live": int(lanes), "lane_steps": int(lane_steps),
              "solve_s": round(dur_s, 6)}
    if tenant is not None:
        fields["tenant"] = tenant
    reg.event("profile", **fields)


# Family order for a scrape mirror (render_metric_lines): matches
# registration order so diffs stay stable.
PROFILE_FAMILIES = (
    "deppy_profile_dispatches_total",
    "deppy_profile_trips_total",
    "deppy_profile_lane_steps_total",
    "deppy_profile_useful_work_ratio",
    "deppy_profile_straggler_p99_ratio",
    "deppy_profile_pad_waste_ratio",
    "deppy_profile_backend_seconds_total",
    "deppy_profile_backend_lanes_total",
)


def render_metric_lines() -> list:
    """Exposition lines for the profiler families: they live on the
    pipeline-global default registry — where the driver records — and
    are absent until the first sampled dispatch, so a disarmed
    process's scrape is unchanged."""
    return telemetry.default_registry().render_families(PROFILE_FAMILIES)


def _backend_counters(reg, backend: str, dur_s: float, lanes: int) -> None:
    reg.counter(
        "deppy_profile_backend_seconds_total",
        "Wall-clock seconds of sampled solve work, by backend "
        "(device / host / hostpool / warm).",
        labelname="backend", initial=0.0).inc(dur_s, label=backend)
    reg.counter(
        "deppy_profile_backend_lanes_total",
        "Lanes solved in sampled dispatches, by backend.",
        labelname="backend").inc(lanes, label=backend)
