"""Multi-process dry run: N local processes joined into one process group (the port's counterpart of ``scripts/dist_dryrun.py:1-257``).

Run from the repository root::

    python -m deppy_tpu_torch.parallel.dist_dryrun --device cuda \\
        --processes 2 --slots 2 --mode batch --family gvk --problems 1000
    python -m deppy_tpu_torch.parallel.dist_dryrun --device cuda \\
        --processes 2 --slots 2 --mode clause --family catalog \\
        --packages 250 --versions 8 --problems 1

The parent builds the kernel library first (``--device cuda``), so the
workers find it built, picks a free port, and spawns ``--processes``
workers, each a real OS process in a session of its own (killed with
its process group at ``--timeout``).  Each worker calls
``initialize_distributed(coordinator_address=..., num_processes=N,
process_id=i)`` (gloo), then:

* ``--mode batch``: builds the same deterministic batch as every other
  rank, keeps its own slices of it (``shard_batch`` over a mesh of
  ``--slots`` slots a rank), solves them on its slots
  (``driver.solve_problems_sharded``) and gathers every rank's results
  with ``replicate``, so that each rank holds the global outcome vector;
* ``--mode clause``: solves each problem clause-sharded over ranks x
  slots (``solve_sharded`` on ``clause_mesh``): every round's OR
  exchange crosses the processes, each round one launch of the round
  kernel a rank (its slots share one card).

Each worker writes its lanes (outcome, installed set, core, steps,
backtracks), its kernel launch counts, its sharded fixpoints and rounds
and the names of any ``jax`` or ``deppy_tpu`` module it loaded.  The
parent solves the same problems in one process (the unsharded batch, or
the one-slot clause solve) while the workers run, and prints one JSON
verdict line:
``{"stage": "dist-dryrun", "ok", "agree", "outcomes", "reference",
...}``; ``agree`` holds when every rank's lanes equal each other and the
reference's, ``ok`` when besides every worker exited 0 and loaded
neither package.  The exit code is 0 exactly when ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _problems(args):
    from ..models import gvk_conflict_catalog, operatorhub_catalog
    from ..sat.encode import encode

    if args.family == "gvk":
        states = [gvk_conflict_catalog(20, 4, 10, seed=i)
                  for i in range(args.problems)]
    else:
        states = [operatorhub_catalog(args.packages, args.versions, seed=i)
                  for i in range(args.problems)]
    return [encode(vs) for vs in states]


def _lane(problem, res) -> list:
    """A result as JSON: outcome, installed and core indices, steps and
    backtracks."""
    installed = res.installed[: problem.n_vars].nonzero().flatten().tolist()
    core = res.core[: problem.n_cons].nonzero().flatten().tolist()
    return [int(res.outcome), installed, core, int(res.steps),
            int(res.trace_n)]


def _forbidden() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))


# -- worker ------------------------------------------------------------------

def worker(args) -> None:
    import torch
    import torch.distributed as dist

    from .. import engine
    from ..engine import core, driver
    from . import (clause_mesh, default_mesh, initialize_distributed,
                   replicate, shard_batch, solve_sharded)

    initialize_distributed(coordinator_address=args.coordinator,
                           num_processes=args.processes,
                           process_id=args.worker,
                           initialization_timeout=args.timeout)
    t0 = time.perf_counter()
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    problems = _problems(args)
    engine.reset_launch_counts()
    rounds0, plain0 = core.sharded_rounds, core.plain_rounds
    fixpoints0 = core.sharded_fixpoints
    if args.mode == "batch":
        mesh = default_mesh([dev] * args.slots)
        idx = shard_batch(mesh, torch.arange(len(problems)))
        mine = [problems[i] for part in idx for i in part.tolist()]
        res = driver.solve_problems_sharded(mine, mesh=mesh)
        lanes = replicate(mesh, [_lane(p, r) for p, r in zip(mine, res)])
    else:
        mesh = clause_mesh([dev] * args.slots)
        lanes = [_lane(p, solve_sharded(p, mesh=mesh)) for p in problems]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    payload = {
        "process": args.worker,
        "ranks": mesh.ranks,
        "shards": mesh.shards,
        "lanes": lanes,
        "launches": engine.launch_counts(),
        "sharded_fixpoints": core.sharded_fixpoints - fixpoints0,
        "sharded_rounds": core.sharded_rounds - rounds0,
        "plain_rounds": core.plain_rounds - plain0,
        "seconds": time.perf_counter() - t0,
        "forbidden": _forbidden(),
    }
    dist.destroy_process_group()
    out_path = os.path.join(args.outdir, f"worker{args.worker}.json")
    with open(out_path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(out_path + ".tmp", out_path)
    print(f"worker {args.worker}: ok ({mesh.ranks} ranks x {mesh.size} "
          f"slots, {len(lanes)} lanes)", flush=True)


# -- parent ------------------------------------------------------------------

def _reference(args) -> list:
    """The same problems in this one process: the unsharded batch, or
    each problem clause-sharded over one slot."""
    import torch

    from ..engine import driver
    from . import clause_mesh, solve_sharded

    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    problems = _problems(args)
    if args.mode == "batch":
        res = driver.solve_problems(problems, device=dev)
    else:
        mesh = clause_mesh([dev])
        res = [solve_sharded(p, mesh=mesh) for p in problems]
    return [_lane(p, r) for p, r in zip(problems, res)]


def _worker_cmd(args, i: int, port: int, outdir: str) -> list:
    return [sys.executable, "-m", "deppy_tpu_torch.parallel.dist_dryrun",
            "--worker", str(i), "--coordinator", f"127.0.0.1:{port}",
            "--processes", str(args.processes), "--slots", str(args.slots),
            "--device", args.device, "--mode", args.mode,
            "--family", args.family, "--problems", str(args.problems),
            "--packages", str(args.packages), "--versions",
            str(args.versions), "--timeout", str(args.timeout),
            "--outdir", outdir]


def parent(args) -> int:
    t0 = time.perf_counter()
    if args.device == "cuda":
        from ..engine import _build, driver

        driver.resolve_device("cuda")
        _build.load()
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix="deppy_dist_")
    procs = [subprocess.Popen(
        _worker_cmd(args, i, port, outdir), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO,
        start_new_session=True) for i in range(args.processes)]
    outs: list = [""] * len(procs)

    def wait(i: int) -> None:
        try:
            outs[i], _ = procs[i].communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(procs[i].pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                procs[i].kill()
            try:
                outs[i], _ = procs[i].communicate(timeout=5)
            except subprocess.TimeoutExpired:
                outs[i] = "(no output: the worker outlived SIGKILL)"
            outs[i] = (outs[i] or "") + "\n<TIMEOUT>"

    threads = [threading.Thread(target=wait, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in threads:
        t.start()
    reference = None
    try:
        reference = _reference(args)
    finally:
        for t in threads:
            t.join()
    ok = all(p.returncode == 0 for p in procs)
    for i, p in enumerate(procs):
        if p.returncode != 0:
            print(f"--- worker {i} rc={p.returncode}\n{(outs[i] or '')[-3000:]}",
                  file=sys.stderr, flush=True)
    records = []
    for i in range(args.processes):
        try:
            with open(os.path.join(outdir, f"worker{i}.json")) as f:
                records.append(json.load(f))
        except OSError:
            ok = False
            print(f"worker {i} wrote no record", file=sys.stderr, flush=True)
    shutil.rmtree(outdir, ignore_errors=True)
    shards = args.processes * args.slots
    agree = bool(records) and len(records) == args.processes and all(
        r["lanes"] == reference and r["shards"] == shards for r in records)
    clean = all(not r["forbidden"] for r in records)
    ok = ok and agree and clean
    verdict = {
        "stage": "dist-dryrun",
        "ok": ok,
        "agree": agree,
        "mode": args.mode,
        "device": args.device,
        "processes": args.processes,
        "slots": args.slots,
        "problems": args.problems,
        "outcomes": ([lane[0] for lane in records[0]["lanes"]]
                     if records else None),
        "reference": [lane[0] for lane in reference],
        "steps": sum(lane[3] for lane in reference),
        "workers": [{k: r[k] for k in ("process", "ranks", "shards",
                                       "launches", "sharded_fixpoints",
                                       "sharded_rounds", "plain_rounds",
                                       "seconds",
                                       "forbidden")} for r in records],
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(verdict), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2,
                    help="mesh slots a process, all on its device")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mode", choices=("batch", "clause"), default="batch")
    ap.add_argument("--family", choices=("gvk", "catalog"),
                    default="catalog",
                    help="gvk_conflict_catalog(20, 4, 10) states, or "
                         "operatorhub_catalog(--packages, --versions)")
    ap.add_argument("--problems", type=int, default=8,
                    help="problems (seeds 0..N-1)")
    ap.add_argument("--packages", type=int, default=6)
    ap.add_argument("--versions", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--outdir", default="")
    args = ap.parse_args(argv)
    if args.worker >= 0:
        worker(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
