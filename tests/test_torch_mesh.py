"""The port's mesh serving on the batch axis against the JAX package's:
the counterpart of ``tests/test_parallel.py`` and ``tests/test_shard.py``.

``tests/conftest.py`` gives the reference 8 virtual CPU devices; the
port's counterpart is a mesh that names the CPU device more than once
(``default_mesh([cpu] * n)``), which drives the same per-slot path: a
worker thread, a breaker and a fault point a slot.

  * the env knob, ``serving_mesh``'s sizing and clamping, ``shard_batch``
    and the scheduler's mesh sizing, each beside the reference's;
  * ``solve_problems_sharded`` over 2 and 4 slots equals the reference's
    over 2 and 4 devices, bit for bit (outcome, installed set, core,
    steps, backtracks), and the unsharded solve; ``spmd=True`` too;
  * a poisoned slot degrades only its slice and charges only its own
    breaker, with the reference's counters and ``/metrics`` lines; the
    open-breaker cases of ``tests/test_shard.py:254-330``;
  * the plumbing: the scheduler's sharded drain, ``Server(mesh_devices=)``,
    ``solve_via(mesh=)``, the checkpoint, ``BatchResolver(mesh=)``, and
    the merged per-shard trip ledgers.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import pytest
import torch

from deppy_tpu import faults as jfaults
from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import profile as tprofile
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.parallel import mesh as tmesh
from deppy_tpu_torch.sat.encode import encode as tencode

jax = pytest.importorskip("jax")

from deppy_tpu.engine import driver as jdriver  # noqa: E402
from deppy_tpu.parallel import mesh as jmesh  # noqa: E402

CPU = torch.device("cpu")
BUDGET = 20000


def within(seconds: float):
    """Fail the test when its body runs past ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "err" in box:
                raise box["err"]
        return run
    return deco


@pytest.fixture(autouse=True)
def fresh_fault_state():
    """Both packages' process breaker, per-device breakers, fault plan
    and default registry, fresh for each test (the reference suite's
    fixture, ``tests/test_shard.py:38-51``)."""
    saved = []
    for f, t in ((jfaults, jtelemetry), (tfaults, ttelemetry)):
        saved.append((f, t, f.set_default_breaker(f.CircuitBreaker()),
                      f.configure_plan(None),
                      t.set_default_registry(t.Registry())))
        f.reset_device_breakers()
    yield
    for f, t, breaker, plan, registry in saved:
        f.reset_device_breakers()
        t.set_default_registry(registry)
        f.configure_plan(plan)
        f.set_default_breaker(breaker)


def _jproblems(n=16, length=20, seed0=0):
    """``tests/test_shard.py:55-60``: the benchmark distribution plus a
    conflict-heavy tail, so models AND unsat cores cross."""
    half = n // 2
    return (
        [jrandom(length=length, seed=s) for s in range(seed0, seed0 + half)]
        + [jrandom(length=length, seed=s, p_mandatory=0.5, p_conflict=0.5,
                   n_conflict=4)
           for s in range(seed0, seed0 + (n - half))])


def _both(n=16, length=20, seed0=0):
    jvars = _jproblems(n, length, seed0)
    return ([jencode(vs) for vs in jvars],
            [tencode(variables_from_objects(vs)) for vs in jvars])


def _lanes(problems, results):
    """Per lane: outcome, the live prefix of the model and the core,
    steps and backtracks (the pad width is a bucketing artifact)."""
    return [(int(r.outcome),
             np.asarray(r.installed)[: p.n_vars].tolist(),
             np.asarray(r.core)[: p.n_cons].tolist(),
             int(r.steps), int(r.trace_n))
            for p, r in zip(problems, results)]


def _decoded(io, driver, problems, results):
    return [io.result_to_dict(r)
            for r in driver.decode_results(problems, results)]


def _cpu_mesh(n):
    return tmesh.default_mesh([CPU] * n)


_REF = {}


def _ref_unsharded(jprobs):
    key = ("base", len(jprobs))
    if key not in _REF:
        _REF[key] = jdriver.solve_problems(jprobs, max_steps=BUDGET)
    return _REF[key]


# ------------------------------------------------------------- the mesh


class TestServingMesh:
    CASES = {"": None, "0": None, "1": None, "off": None, "none": None,
             "all": -1, "-1": -1, "4": 4, "banana": None, "-3": None}

    def test_env_parsing_as_the_reference(self, monkeypatch, capsys):
        for raw, want in self.CASES.items():
            monkeypatch.setenv("DEPPY_GPU_MESH_DEVICES", raw)
            monkeypatch.setenv("DEPPY_TPU_MESH_DEVICES", raw)
            assert tmesh.mesh_devices_from_env() == want, raw
            assert jmesh.mesh_devices_from_env() == want, raw
            err = capsys.readouterr().err
            assert err.count("ignoring malformed") == \
                (2 if raw in ("banana", "-3") else 0)
            if raw in ("banana", "-3"):
                assert (f"ignoring malformed DEPPY_GPU_MESH_DEVICES="
                        f"{raw!r}") in err

    def test_serving_mesh_counts_distinct_devices(self, monkeypatch,
                                                  capsys):
        """The CPU is one device: no mesh at any count (the reference
        under two devices), the clamp warned."""
        monkeypatch.delenv("DEPPY_GPU_MESH_DEVICES", raising=False)
        assert tmesh.serving_mesh(None, device="cpu") is None
        assert tmesh.serving_mesh(1, device="cpu") is None
        assert capsys.readouterr().err == ""
        assert tmesh.serving_mesh(4, device="cpu") is None
        assert "mesh-devices=4 > 1 local devices; clamping to 1" in \
            capsys.readouterr().err
        monkeypatch.setenv("DEPPY_GPU_MESH_DEVICES", "all")
        assert tmesh.serving_mesh(device="cpu") is None

    def test_serving_mesh_sizes_and_clamps_over_cards(self, monkeypatch):
        """Over 8 visible cards the sizes are the reference's over its 8
        virtual devices."""
        monkeypatch.delenv("DEPPY_GPU_MESH_DEVICES", raising=False)
        monkeypatch.delenv("DEPPY_TPU_MESH_DEVICES", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        for n in (None, 1, 4, -1, 999):
            got, ref = tmesh.serving_mesh(n), jmesh.serving_mesh(n)
            assert (None if got is None else got.size) == \
                (None if ref is None else ref.size), n
        assert tmesh.serving_mesh(4).devices == tuple(
            torch.device("cuda", i) for i in range(4))

    def test_default_mesh(self):
        m = tmesh.default_mesh([CPU, CPU, "cpu"])
        assert m.size == 3 and m.devices == (CPU,) * 3
        assert m.distinct() == [CPU]
        assert m == _cpu_mesh(3) and m != _cpu_mesh(2)
        assert tmesh.BATCH_AXIS == jmesh.BATCH_AXIS == "batch"
        with pytest.raises(ValueError):
            tmesh.Mesh([])

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
    def test_default_mesh_needs_the_card(self):
        with pytest.raises(tdriver.NoDeviceError):
            tmesh.default_mesh()
        with pytest.raises(tdriver.NoDeviceError):
            tmesh.default_mesh(["cuda:0", "cuda:0"])

    def test_shard_batch_places_shards(self):
        """``tests/test_parallel.py::test_shard_batch_places_shards``: 16
        rows over 8 slots, 2 rows a slot, every leaf of a tree."""
        m = _cpu_mesh(8)
        arr = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
        shards = tmesh.shard_batch(m, arr)
        assert len(shards) == 8
        for i, s in enumerate(shards):
            assert s.device == CPU
            assert s.tolist() == arr[2 * i: 2 * i + 2].tolist()
        tree = {"a": torch.arange(8), "b": (torch.ones(8, 2),)}
        parts = tmesh.shard_batch(_cpu_mesh(4), tree)
        assert [p["a"].tolist() for p in parts] == \
            [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert all(p["b"][0].shape == (2, 2) for p in parts)
        with pytest.raises(ValueError):
            tmesh.shard_batch(_cpu_mesh(3), arr)

    def test_initialize_distributed_is_a_noop_on_one_host(self,
                                                          monkeypatch):
        """With no arguments and no torchrun environment it joins no
        group, and a mesh stays this process's slots, as the reference's
        single-host no-op (``tests/test_parallel.py``)."""
        import torch.distributed as dist

        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        tmesh.initialize_distributed()
        assert not dist.is_initialized()
        m = _cpu_mesh(4)
        assert (m.ranks, m.rank, m.shards, m.first_shard) == (1, 0, 4, 0)
        assert tmesh.replicate(m, ["a", "b"]) == ["a", "b"]

    def test_scheduler_sizes_micro_batches_to_mesh(self):
        """``tests/test_shard.py::TestServingMesh::
        test_scheduler_sizes_micro_batches_to_mesh`` on both packages."""
        from deppy_tpu.sched import Scheduler as JScheduler
        from deppy_tpu_torch.sched import Scheduler as TScheduler

        for kw, want in ((dict(), 32), (dict(max_fill=16), 16)):
            ref = JScheduler(backend="host", lanes_per_device=4,
                             mesh=jmesh.serving_mesh(8), **kw)
            port = TScheduler(backend="host", lanes_per_device=4,
                              mesh=_cpu_mesh(8), **kw)
            assert port.max_fill == ref.max_fill == want


# ------------------------------------------------ the driver's sharded entry


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_equals_the_reference_bit_for_bit(n_dev):
    """The port's sharded solve over ``n_dev`` CPU slots equals the
    reference's over ``n_dev`` virtual devices lane for lane, and both
    equal their unsharded solves (``tests/test_shard.py``'s byte-identity
    pin at the reference's two shapes)."""
    jprobs, tprobs = _both(16)
    ref = jdriver.solve_problems_sharded(
        jprobs, mesh=jmesh.default_mesh(jax.devices()[:n_dev]),
        max_steps=BUDGET)
    port = tdriver.solve_problems_sharded(tprobs, mesh=_cpu_mesh(n_dev),
                                          max_steps=BUDGET)
    assert _lanes(tprobs, port) == _lanes(jprobs, ref)
    assert _lanes(jprobs, ref) == _lanes(jprobs, _ref_unsharded(jprobs))
    plain = tdriver.solve_problems(tprobs, max_steps=BUDGET, device="cpu")
    assert _lanes(tprobs, port) == _lanes(tprobs, plain)
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_shard_dispatches_total"] == {
        str(d): 1 for d in range(n_dev)}
    assert "deppy_shard_recoveries_total" not in snap or \
        not any(snap["deppy_shard_recoveries_total"].values())


@pytest.mark.parametrize("n_dev", [2, 4])
def test_spmd_spelling_and_mesh_argument_match(n_dev):
    """``spmd=True`` (one fault domain) and ``solve_problems(mesh=)``
    place the same lanes on the same slots and answer as the unsharded
    solve; neither touches a slot's breaker."""
    _, tprobs = _both(16)
    plain = tdriver.solve_problems(tprobs, max_steps=BUDGET, device="cpu")
    spmd = tdriver.solve_problems_sharded(
        tprobs, mesh=_cpu_mesh(n_dev), max_steps=BUDGET, spmd=True)
    placed = tdriver.solve_problems(tprobs, max_steps=BUDGET,
                                    mesh=_cpu_mesh(n_dev))
    assert _lanes(tprobs, spmd) == _lanes(tprobs, plain)
    assert _lanes(tprobs, placed) == _lanes(tprobs, plain)
    assert tfaults.device_breakers() == {}


@pytest.mark.parametrize("seed0,n,n_dev", [(100, 8, 8), (200, 11, 4),
                                           (300, 5, 2)])
def test_fuzz_over_mesh_shapes(seed0, n, n_dev):
    """``tests/test_shard.py::test_fuzz_differential_over_mesh_shapes`` on
    the port: uneven batches and partial meshes never change a verdict, a
    model, a core or a step count."""
    _, tprobs = _both(n, length=16, seed0=seed0)
    plain = tdriver.solve_problems(tprobs, max_steps=BUDGET, device="cpu")
    for spmd in (False, True):
        got = tdriver.solve_problems_sharded(
            tprobs, mesh=_cpu_mesh(n_dev), max_steps=BUDGET, spmd=spmd)
        assert _lanes(tprobs, got) == _lanes(tprobs, plain), spmd


def test_slices_deal_round_robin_past_the_lane_cap():
    assert tdriver._shard_slices(16, 2) == jdriver._shard_slices(16, 2)
    assert tdriver._shard_slices(11, 4) == jdriver._shard_slices(11, 4)
    big = tdriver._shard_slices(3 * tdriver.MAX_LANES + 1, 2)
    assert [len(s) for s in big] == [tdriver.MAX_LANES] * 3 + [1]


def test_single_problem_and_small_mesh_fall_back_to_unsharded():
    _, tprobs = _both(2)
    plain = tdriver.solve_problems(tprobs[:1], max_steps=BUDGET,
                                   device="cpu")
    for mesh in (_cpu_mesh(8), _cpu_mesh(1)):
        got = tdriver.solve_problems_sharded(tprobs[:1], mesh=mesh,
                                             max_steps=BUDGET)
        assert _lanes(tprobs[:1], got) == _lanes(tprobs[:1], plain)
    got = tdriver.solve_problems_sharded(tprobs, mesh=_cpu_mesh(1),
                                         max_steps=BUDGET)
    assert _lanes(tprobs, got) == _lanes(
        tprobs, tdriver.solve_problems(tprobs, max_steps=BUDGET,
                                       device="cpu"))
    snap = ttelemetry.default_registry().snapshot()
    assert "deppy_shard_dispatches_total" not in snap


def test_workers_are_named_and_semantic_errors_pass_through():
    """Each slot drains on ``deppy-shard-{slot}``; a problem with
    encode errors raises before any worker starts, as unsharded."""
    from deppy_tpu_torch.engine import core as tcore
    from deppy_tpu_torch.sat.errors import InternalSolverError

    _, tprobs = _both(8)
    names = set()
    orig = tdriver._solve_split

    def spy(*args, **kwargs):
        names.add(threading.current_thread().name)
        return orig(*args, **kwargs)

    tdriver._solve_split = spy
    try:
        tdriver.solve_problems_sharded(tprobs, mesh=_cpu_mesh(4),
                                       max_steps=BUDGET)
    finally:
        tdriver._solve_split = orig
    assert names == {f"deppy-shard-{i}" for i in range(4)}
    bad = tencode([])
    bad.errors.append("broken")
    with pytest.raises(InternalSolverError):
        tdriver.solve_problems_sharded(tprobs + [bad], mesh=_cpu_mesh(2))
    assert tcore.SAT == 1


# ------------------------------------------------------------- fault domains


def _poison(f, slot):
    f.configure_plan(f.plan_from_spec(
        '[{"point": "driver.shard_dispatch.%d", "kind": "error",'
        ' "times": -1}]' % slot))


@within(120)
def test_poisoned_shard_degrades_only_its_slice(monkeypatch):
    """``tests/test_shard.py::test_poisoned_shard_degrades_only_its_slice``
    on both packages: slot 1's slice recovers on the host engine through
    its own fault domain, slot 0's completes on the device, only breaker
    "1" is charged, and the shard counters and ``/metrics`` lines are the
    reference's."""
    monkeypatch.setenv("DEPPY_TPU_FAULT_BACKOFF_S", "0.001")
    monkeypatch.setenv("DEPPY_GPU_FAULT_BACKOFF_S", "0.001")
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    jprobs, tprobs = _both(16)
    base = _decoded(tio, tdriver, tprobs, tdriver.solve_problems(
        tprobs, max_steps=BUDGET, device="cpu"))
    seen = {}
    for name, f, t, drv, io, probs, mesh in (
            ("reference", jfaults, jtelemetry, jdriver,
             __import__("deppy_tpu.io", fromlist=["x"]), jprobs,
             jmesh.default_mesh(jax.devices()[:2])),
            ("port", tfaults, ttelemetry, tdriver, tio, tprobs,
             _cpu_mesh(2))):
        _poison(f, 1)
        got = drv.solve_problems_sharded(probs, mesh=mesh, max_steps=BUDGET)
        f.configure_plan(None)
        assert _decoded(io, drv, probs, got) == base, name
        assert f.device_breaker("1").blocks_device(), name
        br = f.device_breakers().get("0")
        assert br is None or not br.blocks_device(), name
        assert not f.default_breaker().blocks_device(), name
        snap = t.default_registry().snapshot()
        seen[name] = dict(
            recoveries=snap.get("deppy_shard_recoveries_total"),
            dispatches=snap.get("deppy_shard_dispatches_total"),
            host_routed=snap.get("deppy_fault_host_routed_total"),
            lines=[line for line in f.render_metric_lines()
                   if line.startswith("deppy_breaker_state")])
    assert seen["port"] == seen["reference"]
    assert seen["port"]["recoveries"]["1"] >= 1
    assert 'deppy_breaker_state{device="1"} 2' in seen["port"]["lines"]


@within(120)
def test_open_device_breaker_host_routes_without_attempt():
    """``tests/test_shard.py:277-292``: a slot whose breaker is already
    open never pays an attempt; its slice host-routes at once."""
    for _ in range(tfaults.device_breaker("1").failure_threshold):
        tfaults.device_breaker("1").record_failure()
    assert tfaults.device_breaker("1").blocks_device()
    _, tprobs = _both(16)
    base = tdriver.solve_problems(tprobs, max_steps=BUDGET, device="cpu")
    got = tdriver.solve_problems_sharded(tprobs, mesh=_cpu_mesh(2),
                                         max_steps=BUDGET)
    assert _decoded(tio, tdriver, tprobs, got) == \
        _decoded(tio, tdriver, tprobs, base)
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_fault_host_routed_total"] == 8
    assert snap["deppy_shard_recoveries_total"] == {"1": 1}
    assert "deppy_fault_failures_total" not in snap or \
        snap["deppy_fault_failures_total"] == 0
    assert not tfaults.default_breaker().blocks_device()


@within(120)
def test_open_process_breaker_host_routes_every_shard():
    """``tests/test_shard.py:294-321``: an open PROCESS breaker host-routes
    every shard without an attempt, charges no slot's breaker and keeps
    its half-open probe slot; the reference's counters alike."""
    seen = {}
    for name, f, t, drv, probs, mesh in (
            ("reference", jfaults, jtelemetry, jdriver, _both(8)[0],
             jmesh.default_mesh(jax.devices()[:2])),
            ("port", tfaults, ttelemetry, tdriver, _both(8)[1],
             _cpu_mesh(2))):
        br = f.default_breaker()
        for _ in range(br.failure_threshold):
            br.record_failure()
        got = drv.solve_problems_sharded(probs, mesh=mesh, max_steps=BUDGET)
        assert len(got) == len(probs) and all(r is not None for r in got)
        for key, dbr in f.device_breakers().items():
            assert not dbr.blocks_device(), (name, key)
        assert br.blocks_device(), name
        snap = t.default_registry().snapshot()
        seen[name] = (snap.get("deppy_fault_host_routed_total"),
                      snap.get("deppy_shard_recoveries_total"))
    assert seen["port"] == seen["reference"] == (8, {"0": 1, "1": 1})


def test_gated_breaker_charges_only_the_slot():
    proc, slot = tfaults.CircuitBreaker(), tfaults.device_breaker("3")
    gated = tfaults.GatedDeviceBreaker(slot, proc)
    for _ in range(slot.failure_threshold):
        gated.record_failure()
    assert slot.blocks_device() and not proc.blocks_device()
    assert gated.state() == "open" and gated.blocks_device()
    assert not gated.allow()
    jslot = jfaults.device_breaker("3")
    assert jslot.device == slot.device == "3"
    assert tfaults.device_breakers() == {"3": slot}
    tfaults.reset_device_breakers()
    assert tfaults.device_breakers() == {}


# ------------------------------------------------------------- the plumbing


def _vars(n, seed0=0):
    return [variables_from_objects(vs) for vs in _jproblems(n, seed0=seed0)]


@within(120)
def test_scheduler_sharded_drain_byte_identical_to_unsharded():
    """``tests/test_shard.py::TestSchedulerShardedDrain::
    test_sharded_drain_byte_identical_to_unsharded`` on the port: the same
    answers and the same engine steps, the drain sharded."""
    from deppy_tpu_torch.sched import Scheduler

    probs = _vars(16)
    out = {}
    for label, kw in (("plain", {}), ("meshed", dict(mesh=_cpu_mesh(2)))):
        sched = Scheduler(device="cpu", max_wait_ms=0.0, cache_size=0,
                          incremental="off", **kw)
        sched.start()
        try:
            stats: dict = {}
            got = sched.submit(probs, stats=stats)
        finally:
            sched.stop()
        out[label] = ([tio.result_to_dict(r) for r in got], stats["steps"])
    assert out["meshed"] == out["plain"]
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_shard_dispatches_total"] == {"0": 1, "1": 1}


@within(120)
def test_server_mesh_devices_serves_sharded(monkeypatch):
    """``Server(mesh_devices=2)`` resolves its scheduler's mesh on the
    first device dispatch: here over two CPU slots (the distinct-device
    count made 2), its answers the unsharded server's."""
    import json
    from http.client import HTTPConnection

    from deppy_tpu_torch.service import Server

    monkeypatch.setattr(tmesh, "_local_devices", lambda device: [CPU, CPU])
    doc = json.dumps({"problems": [
        {"variables": [tio.variable_to_dict(v) for v in vs]}
        for vs in _vars(8)]})
    bodies = {}
    for label, kw in (("plain", {}), ("meshed", dict(mesh_devices=2))):
        srv = Server(bind_address="127.0.0.1:0",
                     probe_address="127.0.0.1:0", device="cpu",
                     incremental="off", **kw)
        srv.start()
        try:
            conn = HTTPConnection("127.0.0.1", srv.api_port, timeout=60)
            conn.request("POST", "/v1/resolve", body=doc,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            bodies[label] = resp.read()
            conn.close()
            if kw:
                assert srv.scheduler._resolve_mesh() == _cpu_mesh(2)
                assert srv.scheduler.max_fill == 2 * 256
        finally:
            srv.shutdown()
    assert bodies["meshed"] == bodies["plain"]
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_shard_dispatches_total"] == {"0": 1, "1": 1}


def test_solve_via_and_batch_resolver_over_a_mesh():
    """``solve_via('device', mesh=)`` shards; ``BatchResolver(mesh=)``
    places each dispatch over the slots: both answer as the host engine
    (``tests/test_parallel.py::test_mesh_sharded_batch_matches_host``)."""
    from deppy_tpu_torch import sat as tsat
    from deppy_tpu_torch.engine import registry as tregistry
    from deppy_tpu_torch.resolution import BatchResolver

    jvars = [jrandom(length=24, seed=s) for s in range(8)]
    host = []
    for vs in jvars:
        try:
            host.append(sorted(v.identifier for v in
                               jsat.Solver(vs, backend="host").solve()))
        except jsat.NotSatisfiable:
            host.append(None)
    tvars = [variables_from_objects(vs) for vs in jvars]
    out = BatchResolver(device="cpu", mesh=_cpu_mesh(4)).solve(tvars)
    dev = [None if isinstance(r, tsat.NotSatisfiable)
           else sorted(k for k, v in r.items() if v) for r in out]
    assert dev == host
    probs = [tencode(vs) for vs in tvars]
    lanes = tregistry.solve_via("device", probs, mesh=_cpu_mesh(4),
                                device="cpu")
    assert [r.key() for r in lanes] == [
        r.key() for r in tregistry.solve_via("device", probs, device="cpu")]
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_shard_dispatches_total"] == {
        str(i): 1 for i in range(4)}


def test_checkpoint_over_a_mesh_resumes(tmp_path):
    from deppy_tpu_torch.engine import checkpoint as tcheckpoint

    _, tprobs = _both(16)
    plain = tdriver.solve_problems(tprobs, max_steps=BUDGET, device="cpu")
    for _ in range(2):
        got = tcheckpoint.solve_problems_checkpointed(
            tprobs, str(tmp_path), group=6, max_steps=BUDGET,
            mesh=_cpu_mesh(2))
        assert _lanes(tprobs, got) == _lanes(tprobs, plain)


def test_sharded_dispatch_merges_shard_ledgers():
    """``tests/test_profile.py::TestMergeRules::
    test_sharded_dispatch_merges_shard_ledgers`` on the port: each shard a
    sampled dispatch, their ledgers summed in the batch's report."""
    _, tprobs = _both(16)
    with tprofile.override("on", 1.0):
        sharded = tdriver.solve_problems_sharded(tprobs, mesh=_cpu_mesh(2),
                                                 max_steps=BUDGET)
    rep = ttelemetry.last_report()
    assert rep.profiled_dispatches == 2
    steps = np.array([int(r.steps) for r in sharded])
    assert rep.ledger_lane_steps == int(steps.sum())
    assert rep.ledger_trips == int(steps[:8].max()) + int(steps[8:].max())
    assert 0.0 < rep.useful_work_ratio <= 1.0
    assert rep.n_problems == 16
    assert {k: v for k, v in rep.outcomes.items() if v} == \
        {"sat": 8, "unsat": 8}
