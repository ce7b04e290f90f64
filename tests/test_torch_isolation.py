"""The port stands alone: it imports nothing of JAX or of ``deppy_tpu``,
never runs on the CPU unasked, and a CPU solve launches no kernel."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from deppy_tpu_torch import engine, sat
from deppy_tpu_torch.resolution import BatchResolver

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deppy_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deppy_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_deppy_tpu_import(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_scan_covers_telemetry():
    """The telemetry package is pure Python the port keeps its own copy
    of: the AST scan reads each of its modules."""
    names = {p.name for p in PORT_FILES
             if p.parent.name == "telemetry"}
    assert names == {"__init__.py", "registry.py", "report.py", "trace.py"}


def test_scan_covers_sched_faults_hostpool():
    """The scheduler and the fault, host-lane and incremental packages
    it stands on are the port's own copies: the AST scan reads each of
    their modules."""
    names = {(p.parent.name, p.name) for p in PORT_FILES
             if p.parent.name in ("sched", "faults", "hostpool",
                                  "incremental")}
    assert names == {
        ("incremental", "__init__.py"), ("incremental", "clauseset.py"),
        ("incremental", "warm.py"),
        ("sched", "__init__.py"), ("sched", "cache.py"),
        ("sched", "fair.py"), ("sched", "scheduler.py"),
        ("faults", "__init__.py"), ("faults", "breaker.py"),
        ("faults", "inject.py"),
        ("faults", "metrics.py"), ("faults", "policy.py"),
        ("hostpool", "__init__.py"), ("hostpool", "metrics.py"),
        ("hostpool", "pool.py"), ("hostpool", "worker.py")}


def test_scan_covers_the_racing_modules():
    """The engine registry, the grad_relax entrant, the
    measured-defaults reader and the checkpoint writer are the port's own
    copies: the AST scan reads each."""
    names = {p.name for p in PORT_FILES if p.parent.name == "engine"}
    assert {"registry.py", "grad_relax.py", "defaults.py",
            "checkpoint.py"} <= names


def test_scan_covers_the_session_modules():
    """The session store, the fleet (the handoff, the ring, the router,
    membership and the scale policy) and the session walk's generators
    are the port's own copies: the AST scan reads each of them."""
    names = {(p.parent.name, p.name) for p in PORT_FILES
             if p.parent.name in ("sessions", "fleet")}
    assert names == {
        ("sessions", "__init__.py"), ("sessions", "store.py"),
        ("fleet", "__init__.py"), ("fleet", "ring.py"),
        ("fleet", "snapshot.py"), ("fleet", "router.py"),
        ("fleet", "membership.py"), ("fleet", "policy.py")}
    assert ROOT / "deppy_tpu_torch" / "models" / "session.py" in PORT_FILES


def test_scan_covers_the_profile_and_optimize_modules():
    """The trip profiler, the SLO accountant, the sink report and the
    optimization tier are the port's own copies: the AST scan reads each
    of their modules."""
    names = {(p.parent.name, p.name) for p in PORT_FILES
             if p.parent.name in ("profile", "optimize")}
    assert names == {
        ("profile", "__init__.py"), ("profile", "ledger.py"),
        ("profile", "slo.py"), ("profile", "report.py"),
        ("optimize", "__init__.py"), ("optimize", "objective.py"),
        ("optimize", "loop.py")}


def test_scan_covers_the_speculate_modules():
    """The speculation tier and the publish-churn generators are the
    port's own copies: the AST scan reads each of their modules."""
    names = {p.name for p in PORT_FILES if p.parent.name == "speculate"}
    assert names == {"__init__.py", "manager.py"}
    assert ROOT / "deppy_tpu_torch" / "models" / "publish.py" in PORT_FILES


def test_scan_covers_the_routes_modules():
    """The route-health plane and the distribution-shift waves are the
    port's own copies: the AST scan reads each of their modules."""
    names = {p.name for p in PORT_FILES if p.parent.name == "routes"}
    assert names == {"__init__.py", "ledger.py", "staleness.py",
                     "shadow.py", "learn.py", "report.py"}
    assert ROOT / "deppy_tpu_torch" / "models" / "routes.py" in PORT_FILES


def test_scan_covers_the_obs_modules():
    """The observability plane is the port's own copy: the AST scan reads
    each of its modules."""
    names = {p.name for p in PORT_FILES if p.parent.name == "obs"}
    assert names == {"__init__.py", "stream.py", "aggregate.py",
                     "federate.py", "drift.py", "top.py"}


def test_scan_covers_the_service_and_lease():
    """The service, its HA lease election and the independent solution
    checker are the port's own copies: the AST scan reads each."""
    assert ROOT / "deppy_tpu_torch" / "service.py" in PORT_FILES
    names = {p.name for p in PORT_FILES if p.parent.name == "utils"}
    assert names == {"__init__.py", "lease.py", "verify.py"}


def test_scan_covers_the_cli():
    """The CLI and its ``python -m`` entry point are the port's own
    copies: the AST scan reads both."""
    for name in ("cli.py", "__main__.py"):
        assert ROOT / "deppy_tpu_torch" / name in PORT_FILES


def test_scan_covers_the_config_and_the_mesh():
    """The typed knob registry, the mesh (batch and clause axes, process
    groups and the two-process runner) and the round kernel's wrapper
    are the port's own copies: the AST scan reads each of their
    modules."""
    assert ROOT / "deppy_tpu_torch" / "config.py" in PORT_FILES
    names = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert names == {"__init__.py", "mesh.py", "clause_shard.py",
                     "dist_dryrun.py"}
    assert ROOT / "deppy_tpu_torch" / "engine" / "cuda_shard.py" in \
        PORT_FILES


def test_scan_covers_the_grid_fixpoint_header():
    """The clause path's grid fixpoint (``csrc/grid_fixpoint.cuh``) is a
    header of the kernel build: listed in ``_build.HEADERS``, hashed into
    the library's key, included by the clause kernels' source and free of
    PyTorch's headers (the build is plain nvcc)."""
    from deppy_tpu_torch.engine import _build

    assert "grid_fixpoint.cuh" in _build.HEADERS
    header = _build.CSRC / "grid_fixpoint.cuh"
    source = (_build.CSRC / "shard_round.cu").read_text(encoding="utf-8")
    assert '#include "grid_fixpoint.cuh"' in source
    for text in (header.read_text(encoding="utf-8"), source):
        assert "torch/" not in text and "ATen" not in text
    h0 = _build.source_hash()
    real = _build.HEADERS
    try:
        _build.HEADERS = tuple(h for h in real if h != "grid_fixpoint.cuh")
        assert _build.source_hash() != h0
    finally:
        _build.HEADERS = real


def test_fresh_process_clause_shard_loads_no_jax():
    """A clause-sharded solve over CPU slots, the runner's worker path
    (a spanning mesh, ``shard_batch``, ``replicate``) on one rank, and
    the runner's module import nothing of JAX or deppy_tpu; the runner's
    own workers report what they loaded (tests/test_torch_distributed.py
    holds them to none)."""
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        import torch
        from deppy_tpu_torch.models import operatorhub_catalog
        from deppy_tpu_torch.parallel import (clause_mesh, default_mesh,
                                              dist_dryrun, replicate,
                                              shard_batch, solve_sharded)
        from deppy_tpu_torch.sat.encode import encode
        cpu = torch.device("cpu")
        res = solve_sharded(encode(operatorhub_catalog(6, 2)),
                            mesh=clause_mesh([cpu] * 4))
        assert res.outcome == 1
        mesh = default_mesh([cpu] * 2)
        parts = shard_batch(mesh, torch.arange(4))
        assert replicate(mesh, [p.tolist() for p in parts]) == [[0, 1], [2, 3]]
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_cli_resolve_loads_no_jax(tmp_path):
    """``python -m deppy_tpu_torch resolve --device cpu FILE`` (run as
    ``-m`` runs it) answers and imports nothing of JAX or deppy_tpu."""
    path = tmp_path / "batch.json"
    path.write_text(json.dumps({"problems": [
        {"variables": [{"id": "a", "constraints": [
            {"type": "mandatory"}, {"type": "dependency", "ids": ["b"]}]},
            {"id": "b"}]},
        {"variables": [{"id": "c", "constraints": [
            {"type": "mandatory"}, {"type": "prohibited"}]}]}]}))
    code = textwrap.dedent(f"""
        import runpy, sys
        before = set(sys.modules)
        sys.argv = ["deppy_tpu_torch", "resolve", "--device", "cpu",
                    {str(path)!r}, "--output", "json"]
        try:
            runpy.run_module("deppy_tpu_torch", run_name="__main__")
        except SystemExit as e:
            rc = e.code
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(0 if rc == 1 and not bad and
                 "deppy_tpu_torch.cli" in new else 3)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    answers = json.loads(proc.stdout[:proc.stdout.rindex("BAD")])
    assert [r["status"] for r in answers["results"]] == ["sat", "unsat"]


def test_fresh_process_service_loads_no_jax():
    """``Server(device="cpu")`` starts, answers one ``/v1/resolve`` and a
    scrape, also through a fleet ``Router`` in front of it, and shuts
    down, with neither jax nor deppy_tpu loaded."""
    code = textwrap.dedent("""
        import json, os, sys
        before = set(sys.modules)
        os.environ["DEPPY_GPU_HOST_WORKERS"] = "0"
        from http.client import HTTPConnection
        from deppy_tpu_torch.fleet import membership, router as fleet_router
        from deppy_tpu_torch.service import Server
        srv = Server(device="cpu", bind_address="127.0.0.1:0",
                     probe_address="127.0.0.1:0")
        srv.start()
        router = None
        try:
            conn = HTTPConnection("127.0.0.1", srv.api_port, timeout=60)
            doc = json.dumps({"variables": [
                {"id": "a", "constraints": [{"type": "mandatory"}]}]})
            conn.request("POST", "/v1/resolve", doc,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
            router = fleet_router.Router(
                bind_address="127.0.0.1:0",
                replicas=[f"127.0.0.1:{srv.api_port}"], probe_interval_s=0)
            router.start()
            conn = HTTPConnection("127.0.0.1", router.api_port, timeout=60)
            conn.request("POST", "/v1/resolve", doc,
                         {"Content-Type": "application/json"})
            routed = conn.getresponse()
            routed_body = json.loads(routed.read())
            conn.close()
            view = membership.membership_view(router)
        finally:
            if router is not None:
                router.shutdown()
            srv.shutdown()
        assert resp.status == 200, body
        assert body["results"][0]["selected"] == ["a"], body
        assert "deppy_resolutions_total" in text
        assert (routed.status, routed_body) == (200, body), routed_body
        assert view["members"] == [f"127.0.0.1:{srv.api_port}"], view
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_obs_plane_loads_no_jax():
    """Every obs module, a streamer pushing a CPU scheduler's events to
    an aggregator behind a stdlib HTTP server, and a watchdog on a
    baseline import nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import json, os, sys, tempfile, threading
        before = set(sys.modules)
        os.environ["DEPPY_GPU_HOST_WORKERS"] = "0"
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from deppy_tpu_torch import obs, profile
        from deppy_tpu_torch.models import random_instance
        from deppy_tpu_torch.obs import aggregate, drift, federate, stream, top
        from deppy_tpu_torch.sched import Scheduler
        tmp = tempfile.mkdtemp()
        agg = obs.Aggregator(os.path.join(tmp, "merged.jsonl"))

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                agg.ingest(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = os.path.join(tmp, "baseline.json")
        with open(base, "w") as fh:
            json.dump({"us_per_trip": 100.0}, fh)
        try:
            obs.start_streamer(f"127.0.0.1:{srv.server_address[1]}",
                               replica="r0", flush_ms=5)
            dog = obs.start_watchdog(base, replica="r0")
            sched = Scheduler(device="cpu")
            sched.start()
            try:
                with profile.override("on", 1.0):
                    sched.submit([random_instance(length=12, seed=s)
                                  for s in range(3)])
            finally:
                sched.stop()
            lines = obs.render_metric_lines()
        finally:
            obs.stop_all()
            srv.shutdown()
            srv.server_close()
            agg.close()
        assert agg.counts().get("r0", 0) > 0, agg.counts()
        assert dog is not None and lines and obs.render_metric_lines() == []
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_fresh_process_profiled_optimize_loads_no_jax():
    """An armed profiler over a CPU dispatch and a host drain, the sink's
    report, and a Planner over the CPU scheduler's idle queue import
    nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        before = set(sys.modules)
        from deppy_tpu_torch import profile, telemetry
        from deppy_tpu_torch.models import random_instance
        from deppy_tpu_torch.optimize import Planner
        from deppy_tpu_torch.profile import report
        from deppy_tpu_torch.resolution import BatchResolver
        from deppy_tpu_torch.sched import Scheduler
        sink = os.path.join(tempfile.mkdtemp(), "t.jsonl")
        telemetry.default_registry().configure_sink(sink)
        sched = Scheduler(device="cpu")
        sched.start()
        try:
            with profile.override("on", 1.0):
                BatchResolver(device="cpu").solve(
                    [random_instance(length=12, seed=s) for s in range(3)])
                Scheduler(backend="host").submit(
                    [random_instance(length=12, seed=5)])
                out = Planner(sched).handle({
                    "variables": [{"id": "a"}, {"id": "b"}],
                    "query": "soft", "warm": False,
                    "soft": [{"id": "a", "installed": False}]})
        finally:
            sched.stop()
        telemetry.default_registry().configure_sink(None)
        assert out["status"] == "optimal" and out["selected"] == []
        summary = report.summarize(sink)
        assert set(summary["backends"]) == {"device", "host"}
        assert summary["device_dispatches"] == 2
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_session_loads_no_jax():
    """A session walk on the CPU scheduler, its handoff through the
    snapshot stream and the session generators import nothing of JAX or
    deppy_tpu."""
    code = textwrap.dedent("""
        import json, sys
        before = set(sys.modules)
        from deppy_tpu_torch.fleet import (export_warm_state,
                                           import_warm_state)
        from deppy_tpu_torch.models import session_catalog, walk_steps
        from deppy_tpu_torch.sched import Scheduler
        from deppy_tpu_torch.sessions import SessionStore
        sched = Scheduler(device="cpu")
        store = SessionStore(sched)
        sid = store.create(session_catalog(4, 3))["id"]
        for ident, installed in walk_steps(4, 3, 3):
            store.op(sid, {"op": "assume", "identifiers": [ident],
                           "installed": installed})
            assert store.op(sid, {"op": "resolve"})["result"]["status"] \
                == "sat"
        doc = json.loads(json.dumps(export_warm_state(sched,
                                                      sessions=store)))
        other = SessionStore(Scheduler(device="cpu"))
        assert import_warm_state(sched, doc, sessions=other)[
            "sessions_imported"] == 1
        store.stop()
        other.stop()
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_cpu_solve_loads_no_jax():
    """A CPU batch, a traced Solver whose report is read, a racing
    scheduler (device, host and grad_relax entrants) and a batch through
    the request scheduler import nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        from deppy_tpu_torch import sat, telemetry
        from deppy_tpu_torch.models import pinned_tenant_catalog
        from deppy_tpu_torch.resolution import BatchResolver
        out = BatchResolver(device="cpu").solve(
            [pinned_tenant_catalog(seed=s) for s in range(2)])
        assert len(out) == 2
        tracer = sat.StatsTracer()
        solver = sat.Solver([
            sat.variable("a", sat.mandatory(), sat.dependency("b", "c")),
            sat.variable("c"),
            sat.variable("b", sat.dependency("x"), sat.dependency("w")),
            sat.variable("x", sat.conflict("w")), sat.variable("w"),
        ], tracer=tracer, device="cpu", trace_cap=4)
        assert [v.identifier for v in solver.solve()] == ["a", "c"]
        assert tracer.backtracks == solver.backtracks > 0
        assert isinstance(solver.report, telemetry.SolveReport)
        assert solver.report.backtracks == solver.backtracks
        from deppy_tpu_torch.sched import Scheduler
        racing = Scheduler(device="cpu", portfolio="on", portfolio_k=3,
                           cache_size=0)
        assert len(racing.submit([pinned_tenant_catalog(seed=0)] * 2)) == 2
        sched = Scheduler(device="cpu", max_wait_ms=0.0)
        sched.start()
        try:
            resolver = BatchResolver(scheduler=sched)
            states = [pinned_tenant_catalog(seed=s) for s in range(2)]
            assert [type(r) for r in resolver.solve(states)] == \
                [type(r) for r in out]
            assert resolver.last_steps > 0
        finally:
            sched.stop()
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_surface_loads_no_jax():
    """A Resolver solve over entities and generators on the CPU, the host
    backend and an io round trip import nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import json, sys
        before = set(sys.modules)
        from deppy_tpu_torch import io
        from deppy_tpu_torch.entity import CacheQuerier
        from deppy_tpu_torch.models import (operatorhub_entities,
                                            operatorhub_generators)
        from deppy_tpu_torch.resolution import BatchResolver, Resolver
        q = CacheQuerier.from_entities(operatorhub_entities(6, 2))
        gens = operatorhub_generators(q)
        assert Resolver(q, *gens, device="cpu").solve() == Resolver(
            q, *gens, backend="host").solve()
        doc = json.loads(json.dumps({"problems": [
            {"variables": [io.variable_to_dict(v)
                           for v in gens[0](q) + gens[1](q)]}]}))
        out = BatchResolver(device="cpu").solve(
            io.problems_from_document(doc))
        assert io.result_to_dict(out[0])["status"] == "sat"
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fresh_process_auto_and_checkpoint_load_no_jax(tmp_path):
    """``auto`` resolution on the CPU, a BatchResolver under ``auto``, a
    faulted dispatch through the envelope and a checkpointed CPU solve
    import nothing of JAX or deppy_tpu."""
    code = textwrap.dedent(f"""
        import sys
        before = set(sys.modules)
        from deppy_tpu_torch import faults
        from deppy_tpu_torch.engine import checkpoint
        from deppy_tpu_torch.models import pinned_tenant_catalog
        from deppy_tpu_torch.resolution import BatchResolver
        from deppy_tpu_torch.sat.encode import encode
        from deppy_tpu_torch.sat.solver import resolve_backend
        assert resolve_backend("auto", device="cpu") == "device"
        states = [pinned_tenant_catalog(seed=s) for s in range(2)]
        plain = BatchResolver(backend="auto", device="cpu").solve(states)
        faults.configure_plan(faults.plan_from_spec(
            '[{{"point": "driver.dispatch", "times": 1}}]'))
        out = checkpoint.solve_problems_checkpointed(
            [encode(vs) for vs in states], {str(tmp_path)!r}, group=1,
            device="cpu")
        assert len(out) == len(plain) == 2
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_without_a_card_raises(monkeypatch):
    from deppy_tpu_torch.entity import CacheQuerier
    from deppy_tpu_torch.resolution import Resolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = [sat.variable("a", sat.mandatory())]
    with pytest.raises(RuntimeError, match="cuda"):
        BatchResolver().solve([problem])
    with pytest.raises(RuntimeError, match="cuda"):
        sat.Solver(problem).solve()
    with pytest.raises(RuntimeError, match="cuda"):
        sat.Solver(problem, backend="device").solve()
    with pytest.raises(RuntimeError, match="cuda"):
        Resolver(CacheQuerier({}), lambda q: problem).solve()
    scoped = sat.Solver(problem)
    scoped.assume("a")
    scoped.test()
    with pytest.raises(RuntimeError, match="cuda"):
        scoped.solve()


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        sat.Solver([sat.variable("a")], device="meta").solve()


def test_cpu_solve_launches_no_kernel():
    from deppy_tpu_torch.models import pinned_tenant_catalog

    engine.reset_launch_counts()
    out = BatchResolver(device="cpu").solve(
        [pinned_tenant_catalog(seed=s) for s in range(3)])
    assert len(out) == 3
    assert engine.launch_counts() == {k: 0 for k in engine.KERNELS}


def test_build_happens_at_first_use_only():
    """Importing the package builds nothing: the library is loaded (and
    built) by the first CUDA launch."""
    from deppy_tpu_torch.engine import _build

    assert _build._LIB is None or torch.cuda.is_available()
    assert set(_build.SOURCES) == {"bcp.cu", "blockwise.cu", "search.cu",
                                   "minimize.cu", "core.cu",
                                   "shard_round.cu", "probe.cu"}
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
