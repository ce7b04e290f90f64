"""The forkserver-backed host-engine worker pool (copy of ``deppy_tpu/hostpool/pool.py``).

One :class:`HostPool` per process (:func:`default_pool`), started lazily
on the first dispatch.  The parent keeps one duplex pipe per worker and
multiplexes results and worker deaths with ``multiprocessing.connection.
wait``:

  * a worker that dies mid-solve is detected by its pipe or process
    sentinel, its lanes retried on a fresh worker
    (``deppy_fault_retries`` charged,
    ``deppy_hostpool_worker_crashes_total`` counted) up to the retry
    policy's ``max_attempts`` tries (``DEPPY_GPU_FAULT_RETRIES``, read at
    each dispatch), then solved inline — answers survive any crash;
  * workers recycle after ``DEPPY_GPU_HOST_WORKER_RECYCLE`` solves;
  * per-lane deadlines cancel only the expired lane: queued lanes are
    triaged at assignment (and again worker-side just before the solve);
  * a fork-restricted sandbox (or any spawn failure) marks the pool
    unavailable and every consumer falls back to the inline engine —
    byte-identically, because the fallback runs the same
    :func:`~deppy_tpu_torch.hostpool.worker.solve_lane` the workers run.

The start method is always ``forkserver``: the forkserver is a fresh
interpreter whose preload is the torch-free
:mod:`deppy_tpu_torch.hostpool.worker`, so no worker inherits the
parent's CUDA context (a forked CUDA context is unusable and can hang
the child).

Dispatches are serialized by one pool lock (a plain ``threading`` lock:
the reference's lockdep proxy is ROADMAP A7) and run under a
``hostpool.dispatch`` span; each lane's worker-side wall clock comes
back in its result and is recorded as a ``hostpool.worker_solve`` span
on the submitting thread when a sink or trace observes it.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import List, Optional, Sequence, Union

from .. import config, faults, telemetry
from . import metrics
from .worker import HostLaneResult, _degraded_result, solve_lane, worker_main

# Worker-count policy: DEPPY_GPU_HOST_WORKERS, default min(cpu_count, 8).  0 disables the pool outright.  An
# UNCONFIGURED default of 1 (single-core box) also disables it: a
# one-worker pool is pure IPC overhead there — but an EXPLICIT 1 is
# honored (a 1-vs-N comparison isolates exactly that overhead).
DEFAULT_MAX_WORKERS = 8
# Workers retire after this many solves and are replaced (0 = never).
DEFAULT_RECYCLE_AFTER = 256
# Bound on waiting for a spawned worker's ready handshake; a sandbox
# that allows fork but hangs it must not hang the solve path.
DEFAULT_SPAWN_TIMEOUT_S = 30.0


class HostPoolError(RuntimeError):
    """Pool infrastructure failure (spawn refused, workers gone).

    Never a solve verdict: consumers catch it and fall back to the
    inline engine, byte-identically.  Semantic outcomes
    (``InternalSolverError`` from a malformed problem) propagate
    through the pool untouched."""


def pool_workers() -> int:
    """The configured worker count: explicit override
    (:func:`configure_pool`), else ``DEPPY_GPU_HOST_WORKERS``, else
    ``min(cpu_count, 8)``."""
    if _OVERRIDE_WORKERS is not None:
        return _OVERRIDE_WORKERS
    raw = config.env_raw("DEPPY_GPU_HOST_WORKERS")
    if raw is not None and raw.strip():
        return max(faults.env_int("DEPPY_GPU_HOST_WORKERS", 0), 0)
    return min(os.cpu_count() or 1, DEFAULT_MAX_WORKERS)


def _workers_explicit() -> bool:
    if _OVERRIDE_WORKERS is not None:
        return True
    raw = config.env_raw("DEPPY_GPU_HOST_WORKERS")
    return raw is not None and bool(raw.strip())


def effective_workers() -> int:
    """Workers the host path will actually use: 0 = inline serial
    engine (pool disabled or not engaged)."""
    n = pool_workers()
    if n < 1 or (n < 2 and not _workers_explicit()):
        return 0
    return n


class _Worker:
    __slots__ = ("proc", "conn", "solves", "busy_seqs", "wid")

    def __init__(self, proc, conn, wid: int):
        self.proc = proc
        self.conn = conn
        self.solves = 0
        # In-flight chunk seqs, FIFO.  Up to _PIPELINE_DEPTH chunks are
        # outstanding per worker so the pipe buffer hides the parent's
        # serialization latency: with one chunk in flight the worker
        # idles for the whole recv→process→pickle→send gap between
        # chunks.
        self.busy_seqs: deque = deque()
        self.wid = wid


# Outstanding chunks per worker (2 = double buffering: one solving, one
# queued in the pipe).  More buys nothing and worsens crash-retry and
# deadline-triage granularity.
_PIPELINE_DEPTH = 2


class HostPool:
    """A pool of host-engine worker processes solving lanes concurrently."""

    def __init__(self, workers: Optional[int] = None,
                 recycle_after: Optional[int] = None,
                 spawn_timeout_s: Optional[float] = None):
        self.workers = workers if workers is not None else pool_workers()
        if recycle_after is None:
            recycle_after = faults.env_int(
                "DEPPY_GPU_HOST_WORKER_RECYCLE", DEFAULT_RECYCLE_AFTER)
        self.recycle_after = max(int(recycle_after), 0)
        if spawn_timeout_s is None:
            spawn_timeout_s = faults.env_float(
                "DEPPY_GPU_HOSTPOOL_SPAWN_TIMEOUT_S",
                DEFAULT_SPAWN_TIMEOUT_S, warn=True)
        self.spawn_timeout_s = float(spawn_timeout_s)
        # One lock serializes dispatches AND lifecycle; a dispatch in
        # flight therefore drains before shutdown proceeds.
        self._lock = threading.Lock()
        self._ctx = None
        self._workers: List[_Worker] = []
        self._next_wid = 0
        self._unavailable: Optional[str] = None  # sticky failure reason
        self._started = False
        self._shutdown = False
        self._last_crashes = 0
        # Pool-lifetime monotonic task counter.  Never per-dispatch: an
        # engine error escaping a dispatch (fail-loud InternalSolverError
        # re-raised from an inline re-solve) leaves pipelined chunks in
        # flight, and a per-dispatch counter restarting at 0 would let
        # the NEXT dispatch adopt those stale results as its own lanes'
        # answers.  With a monotonic seq, a stale message resolves to no
        # chunk and is dropped.
        self._seq = 0

    # ------------------------------------------------------------ lifecycle

    def _ensure_started_locked(self) -> None:
        if self._shutdown:
            raise HostPoolError("host pool is shut down")
        if self._unavailable is not None:
            raise HostPoolError(
                f"host pool unavailable: {self._unavailable}")
        if self._started:
            if not self._workers:
                raise HostPoolError("host pool has no live workers")
            return
        if self.workers < 1:
            self._unavailable = "configured with zero workers"
            raise HostPoolError(self._unavailable)
        try:
            import multiprocessing as mp

            self._ctx = mp.get_context("forkserver")
            try:
                # Preload the worker module (numpy + the sat layer, no
                # torch) into the forkserver so every forked worker
                # starts warm instead of re-importing per process.
                self._ctx.set_forkserver_preload(
                    ["deppy_tpu_torch.hostpool.worker"])
            except (ValueError, RuntimeError):
                pass  # forkserver already running: keep its state
            for _ in range(self.workers):
                self._workers.append(self._spawn_locked())
        except HostPoolError:
            self._teardown_locked()
            raise
        except Exception as e:  # fork-restricted sandbox, missing ctx, ...
            self._teardown_locked()
            self._unavailable = f"{type(e).__name__}: {e}"
            raise HostPoolError(
                f"host pool unavailable: {self._unavailable}") from e
        self._started = True
        metrics.gauge("deppy_hostpool_workers").set(len(self._workers))

    def _spawn_locked(self) -> _Worker:
        """Start one worker and wait for its ready handshake."""
        import sys

        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        wid = self._next_wid
        self._next_wid += 1
        proc = self._ctx.Process(
            target=worker_main, args=(child_conn, wid),
            name=f"deppy-hostpool-{wid}", daemon=True)
        # Script-less interpreters (``python - <<EOF``, some REPL
        # embeddings) carry a ``__main__.__file__`` of "<stdin>"; the
        # forkserver's child prep re-runs that path and dies before the
        # ready handshake.  The worker never needs the caller's main
        # module — strip the phantom path for the instant the prep data
        # is captured so heredoc-driven library use still gets a pool.
        main = sys.modules.get("__main__")
        main_file = getattr(main, "__file__", None)
        strip = (main_file is not None
                 and getattr(main, "__spec__", None) is None
                 and not os.path.exists(main_file))
        if strip:
            del main.__file__
        try:
            proc.start()
        finally:
            if strip:
                main.__file__ = main_file
        child_conn.close()
        if not parent_conn.poll(self.spawn_timeout_s):
            proc.terminate()
            proc.join(5)
            parent_conn.close()
            raise HostPoolError(
                f"worker {wid} never reported ready within "
                f"{self.spawn_timeout_s}s")
        msg = parent_conn.recv()
        if msg[0] != "ready":
            proc.terminate()
            proc.join(5)
            parent_conn.close()
            raise HostPoolError(
                f"worker {wid} bad handshake: {msg!r}")
        return _Worker(proc, parent_conn, wid)

    def _retire_locked(self, w: _Worker, graceful: bool) -> None:
        if graceful:
            try:
                w.conn.send(("exit",))
            except (OSError, ValueError):
                pass
        try:
            w.conn.close()
        except OSError:
            pass
        w.proc.join(5 if graceful else 1)
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(5)

    def _teardown_locked(self) -> None:
        for w in self._workers:
            self._retire_locked(w, graceful=False)
        self._workers = []
        metrics.gauge("deppy_hostpool_workers").set(0)

    @property
    def running(self) -> bool:
        # Consistent triple under the pool lock; never called while
        # holding it — the in-class consumers are the *_locked* helpers,
        # which read the fields directly.
        with self._lock:
            return (self._started and not self._shutdown
                    and bool(self._workers))

    @property
    def available(self) -> bool:
        with self._lock:
            return self._unavailable is None and not self._shutdown

    def worker_pids(self) -> List[int]:
        with self._lock:
            return [w.proc.pid for w in self._workers]

    def shutdown(self) -> None:
        """Drain (the lock serializes against any in-flight dispatch),
        then exit every worker; stragglers are terminated.  Idempotent;
        the pool refuses further dispatches afterwards."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for w in self._workers:
                self._retire_locked(w, graceful=True)
            self._workers = []
            if self._started:
                metrics.gauge("deppy_hostpool_workers").set(0)

    # -------------------------------------------------------------- solving

    def solve(self, problems: Sequence,
              max_steps: Union[int, Sequence[Optional[int]], None] = None,
              deadlines: Optional[Sequence] = None) -> List[HostLaneResult]:
        """Solve independent lanes concurrently across the workers.

        Raises :class:`HostPoolError` (pool infrastructure) for the
        caller's inline fallback; ``InternalSolverError`` and friends
        from the engine itself propagate typed (a crashed-retry-exhausted
        or engine-errored lane is re-solved inline in THIS process, so
        the real exception surfaces exactly as the serial loop's would).
        """
        faults.inject("hostpool.dispatch")
        n = len(problems)
        per_lane_steps = (list(max_steps) if isinstance(max_steps, (list,
                                                                    tuple))
                          else [max_steps] * n)
        dls = list(deadlines) if deadlines is not None else [None] * n
        with self._lock:
            self._ensure_started_locked()
            reg = telemetry.default_registry()
            metrics.counter("deppy_hostpool_dispatches_total").inc()
            with reg.span("hostpool.dispatch", lanes=n,
                          workers=len(self._workers)) as sp:
                try:
                    results = self._solve_locked(problems, per_lane_steps,
                                                 dls, reg)
                finally:
                    # An escaping engine error (fail-loud path) may
                    # leave pipelined chunks in flight — their stale
                    # results drop by seq on the next dispatch, but the
                    # gauges must read idle between dispatches.
                    metrics.gauge("deppy_hostpool_queue_depth").set(0)
                    metrics.gauge("deppy_hostpool_busy_workers").set(0)
                sp.set(crashes=self._last_crashes)
            return results

    def _solve_locked(self, problems, per_lane_steps, dls, reg):
        from multiprocessing.connection import wait as mp_wait

        n = len(problems)
        results: List[Optional[HostLaneResult]] = [None] * n
        attempts = [0] * n
        # Tries of one lane across worker crashes before it is solved
        # inline: the device dispatch's retry policy (pool.py:351).
        max_attempts = max(faults.RetryPolicy.from_env().max_attempts, 1)
        # Tasks are CHUNKS of lanes: per-lane tasks run slower than the
        # serial loop (the pipe round trip eats the concurrency on ~ms
        # solves).  Oversubscribe 4 chunks per worker so stragglers
        # rebalance while the round trip amortizes over several lanes.
        chunk = max(1, -(-n // (max(len(self._workers), 1) * 4)))
        pending = deque([list(range(lo, min(lo + chunk, n)))
                         for lo in range(0, n, chunk)])
        seq_to_chunk = {}
        self._last_crashes = 0
        g_depth = metrics.gauge("deppy_hostpool_queue_depth")
        g_busy = metrics.gauge("deppy_hostpool_busy_workers")
        h_solve = metrics.histogram("deppy_hostpool_worker_solve_seconds")
        c_lanes = metrics.counter("deppy_hostpool_lanes_total")

        def busy():
            return [w for w in self._workers if w.busy_seqs]

        def finish_inline(i):
            # Last line: this process IS the inline engine, so answers
            # (and loud, typed engine errors) survive any pool failure.
            results[i] = solve_lane(problems[i],
                                    max_steps=per_lane_steps[i],
                                    deadline=dls[i])

        def assign():
            while pending:
                open_ws = [w for w in self._workers
                           if len(w.busy_seqs) < _PIPELINE_DEPTH]
                if not open_ws:
                    break
                # Least-loaded first: fill every worker's first slot
                # before any second, so the pipeline never serializes
                # two chunks behind one worker while another sits idle.
                w = min(open_ws, key=lambda x: len(x.busy_seqs))
                lanes = pending.popleft()
                live = []
                for i in lanes:
                    if results[i] is not None:
                        continue
                    if dls[i] is not None and dls[i].expired():
                        # Cancel only THIS lane's future: queued
                        # batchmates keep their worker slots.
                        results[i] = _degraded_result()
                    else:
                        live.append(i)
                if not live:
                    continue
                crash = False
                try:
                    faults.inject("hostpool.worker_crash")
                except faults.InjectedFault:
                    crash = True
                seq = self._seq
                self._seq += 1
                payloads = [{
                    "problem": problems[i],
                    "max_steps": per_lane_steps[i],
                    "deadline_s": (dls[i].remaining()
                                   if dls[i] is not None else None),
                } for i in live]
                try:
                    w.conn.send(("task", seq, payloads, crash))
                except (OSError, ValueError):
                    # Worker died between dispatches: same handling as a
                    # mid-solve crash (the attempt budget still bounds a
                    # worker population that keeps dying on startup).
                    self._on_crash_locked(w, live, pending, attempts,
                                          max_attempts, finish_inline)
                    continue
                w.busy_seqs.append(seq)
                seq_to_chunk[seq] = live
            g_depth.set(sum(len(c) for c in pending))
            g_busy.set(len(busy()))

        assign()
        while any(r is None for r in results):
            if not self._workers:
                # Every worker (and respawn) is gone: the rest solves
                # inline rather than failing answers already promised.
                for i in range(n):
                    if results[i] is None:
                        finish_inline(i)
                break
            if not busy():
                # Lanes remain but nothing is in flight (all pending
                # were degraded, or sends failed): try assigning again;
                # if nothing sticks, drain inline.
                assign()
                if not busy():
                    for i in range(n):
                        if results[i] is None:
                            finish_inline(i)
                    break
                continue
            conns = {w.conn: w for w in busy()}
            # The worker pipe is the authoritative death signal: a dead
            # worker's conn reads EOF, and EOF (unlike the process
            # sentinel, whose forkserver relay can lag or be swallowed
            # by a PID-1-less sandbox) is level-triggered — deferring it
            # would spin the loop.  Sentinels ride along only to wake
            # the wait for pipe-less deaths.
            sentinels = {w.proc.sentinel: w for w in busy()}
            ready = mp_wait(list(conns) + list(sentinels))
            handled = set()
            for r in ready:
                w = conns.get(r, sentinels.get(r))
                if w is None or id(w) in handled:
                    continue
                handled.add(id(w))
                alive = True
                # Drain every queued message first: results may have
                # been sent just before death.
                while w.busy_seqs and w.conn.poll(0):
                    alive = self._on_message_locked(
                        w, results, seq_to_chunk, h_solve, c_lanes, reg,
                        finish_inline)
                    if not alive:
                        break
                if w.busy_seqs and (not alive or not w.proc.is_alive()):
                    lanes = [i for seq in w.busy_seqs
                             for i in seq_to_chunk.pop(seq, [])]
                    self._on_crash_locked(w, lanes, pending, attempts,
                                          max_attempts, finish_inline)
                elif (not w.busy_seqs and w in self._workers
                      and not w.proc.is_alive()):
                    # Died idle (shouldn't happen): just replace it.
                    self._replace_locked(w, count_crash=False)
            assign()
        g_depth.set(0)
        g_busy.set(0)
        return results

    def _on_message_locked(self, w, results, seq_to_chunk, h_solve,
                           c_lanes, reg, finish_inline) -> bool:
        """Process one queued worker message; False means the pipe hit
        EOF (the worker is dead — caller runs the crash path)."""
        try:
            msg = w.conn.recv()
        except (EOFError, OSError):
            return False
        _, seq, out = msg
        lanes = seq_to_chunk.pop(seq, [])
        try:
            w.busy_seqs.remove(seq)
        except ValueError:
            pass
        w.solves += len(lanes)
        for lane, res in zip(lanes, out):
            if results[lane] is not None:
                continue  # stale (solved inline after a crash storm)
            if isinstance(res, HostLaneResult):
                results[lane] = res
                if not res.degraded:
                    c_lanes.inc()
                    h_solve.observe(res.wall_s)
                    # Worker-side timing, recorded on the submitting
                    # thread so the span joins THIS request's trace (the
                    # same move the scheduler's queue-wait span makes).
                    # Gated on an actual observer: with neither a sink
                    # nor an active trace, a per-lane span is parent CPU
                    # taken straight from the workers, and the histogram
                    # above already carries the timing.
                    from ..telemetry import trace as _trace

                    if (reg.sink_path is not None
                            or _trace.current_context() is not None):
                        reg.record_span("hostpool.worker_solve",
                                        res.wall_s, lane=lane,
                                        worker=w.wid)
            else:  # ("err", messages): engine fault — fail loud,
                # typed, by re-raising from an inline re-solve.
                reg.event("fault", fault="hostpool_worker_error",
                          messages=res[1], lane=lane)
                finish_inline(lane)
        # Recycle only between chunks: a retiring worker must not strand
        # a pipelined task still sitting in its pipe.
        if (self.recycle_after and w.solves >= self.recycle_after
                and not w.busy_seqs):
            metrics.counter("deppy_hostpool_worker_recycles_total").inc()
            self._replace_locked(w, count_crash=False)
        return True

    def _on_crash_locked(self, w, lanes, pending, attempts, max_attempts,
                         finish_inline) -> None:
        """One worker died mid-chunk: count it, charge the retry
        counter, respawn a fresh worker, and requeue the chunk's
        unfinished lanes to re-run there (or solve them inline once
        their attempts exhaust)."""
        metrics.counter("deppy_hostpool_worker_crashes_total").inc()
        faults.fault_counter("deppy_fault_retries").inc()
        telemetry.default_registry().event(
            "fault", fault="hostpool_worker_crash", worker=w.wid,
            exitcode=w.proc.exitcode, lanes=len(lanes))
        retry = []
        for lane in lanes:
            attempts[lane] += 1
            if attempts[lane] >= max_attempts:
                finish_inline(lane)
            else:
                retry.append(lane)
        if retry:
            pending.appendleft(retry)
        self._replace_locked(w, count_crash=True)

    def _replace_locked(self, w: _Worker, count_crash: bool) -> None:
        if w in self._workers:
            self._workers.remove(w)
        self._retire_locked(w, graceful=not count_crash)
        if count_crash:
            self._last_crashes += 1
        try:
            self._workers.append(self._spawn_locked())
        except Exception as e:  # any spawn failure, HostPoolError included
            # Respawn refused (sandbox tightened mid-run): shrink; the
            # solve loop drains inline once the pool empties.  Loud on
            # the sink: a pool silently shrinking to empty is the flight
            # recorder's business.
            telemetry.default_registry().event(
                "fault", fault="hostpool_respawn_failed",
                error=type(e).__name__, workers=len(self._workers))
        metrics.gauge("deppy_hostpool_workers").set(len(self._workers))


# ---------------------------------------------------------------- inline path


def solve_inline(problems: Sequence,
                 max_steps: Union[int, Sequence[Optional[int]], None] = None,
                 deadlines: Optional[Sequence] = None) -> List[HostLaneResult]:
    """The serial reference path: the same :func:`solve_lane` the
    workers run, in-process, in order.  Per-lane deadline triage before
    each solve reproduces the historical "break at expiry, degrade the
    remainder" host-loop semantics exactly (a shared deadline that
    expires mid-batch fails every subsequent lane's triage)."""
    n = len(problems)
    per_lane_steps = (list(max_steps)
                      if isinstance(max_steps, (list, tuple))
                      else [max_steps] * n)
    dls = list(deadlines) if deadlines is not None else [None] * n
    return [solve_lane(p, max_steps=s, deadline=d)
            for p, s, d in zip(problems, per_lane_steps, dls)]


# --------------------------------------------------------------- default pool

_OVERRIDE_WORKERS: Optional[int] = None
_DEFAULT: Optional[HostPool] = None
_DEFAULT_LOCK = threading.Lock()


def configure_pool(workers: Optional[int]) -> None:
    """Install an explicit worker count; replaces the default pool on
    next use.  ``None`` restores env/default
    resolution."""
    global _OVERRIDE_WORKERS, _DEFAULT
    with _DEFAULT_LOCK:
        _OVERRIDE_WORKERS = workers
        old, _DEFAULT = _DEFAULT, None
    if old is not None:
        old.shutdown()


def default_pool() -> Optional[HostPool]:
    """The process-wide pool, or ``None`` when pooling is disabled:
    explicitly (``DEPPY_GPU_HOST_WORKERS=0``), or implicitly on a
    single-core box where the unconfigured default of 1 worker would be
    pure IPC overhead (an explicit 1 is honored)."""
    global _DEFAULT
    n = effective_workers()
    if n < 1:
        return None
    pool = _DEFAULT
    if pool is not None and pool.workers == n and not pool._shutdown:
        return pool
    stale = None
    with _DEFAULT_LOCK:
        pool = _DEFAULT
        if pool is None or pool.workers != n or pool._shutdown:
            stale = pool
            _DEFAULT = HostPool(workers=n)
            pool = _DEFAULT
    if stale is not None:
        stale.shutdown()
    return pool


def shutdown_default_pool() -> None:
    """Graceful shutdown of the default pool (a server's drain, a
    script's exit)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        pool, _DEFAULT = _DEFAULT, None
    if pool is not None:
        pool.shutdown()


def solve_host_problems(problems: Sequence,
                        max_steps: Union[int, Sequence[Optional[int]],
                                         None] = None,
                        deadlines: Optional[Sequence] = None,
                        pool: Optional[HostPool] = None,
                        ) -> List[HostLaneResult]:
    """THE host-path entry every consumer calls (the ``Solver``'s host
    lane, ``BatchResolver``'s host batch, the scheduler's host drain,
    its straggler triage and the racer's ``hostpool`` entrant): pool
    when one is available and the batch has parallelism to exploit,
    inline otherwise — bit-identical either way.

    Pool infrastructure failures (fork-restricted sandbox, injected
    ``hostpool.dispatch`` faults, worker exhaustion) degrade to the
    inline engine loudly (``deppy_hostpool_inline_fallback_total`` +
    a ``fault`` sink event), never to an error: the inline engine is the
    actual last line of defense, and ITS faults stay loud and typed."""
    if pool is None:
        pool = default_pool()
    if pool is not None and len(problems) > 1:
        try:
            return pool.solve(problems, max_steps=max_steps,
                              deadlines=deadlines)
        except (HostPoolError, faults.InjectedFault) as e:
            metrics.counter("deppy_hostpool_inline_fallback_total").inc()
            telemetry.default_registry().event(
                "fault", fault="hostpool_inline_fallback",
                error=type(e).__name__, problems=len(problems))
    return solve_inline(problems, max_steps=max_steps, deadlines=deadlines)
