"""The port's process groups (the counterpart of
``tests/test_distributed.py``): the two-process runner
``python -m deppy_tpu_torch.parallel.dist_dryrun`` on the CPU in both
modes, ``initialize_distributed``'s no-op and its failure, and the
kernel build's race between two ranks.

Every subprocess and every wait is bounded; a process group is only ever
initialized in a subprocess, so no test leaves one behind.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from deppy_tpu_torch.engine import _build
from deppy_tpu_torch.parallel import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]


def _verdict(stdout: str) -> dict:
    for line in stdout.splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and doc.get("stage") == "dist-dryrun":
            return doc
    raise AssertionError(f"no verdict line in:\n{stdout[-2000:]}")


@pytest.mark.parametrize("mode", ["batch", "clause"])
def test_two_process_runner_agrees_with_one_process(mode):
    """2 processes x 2 slots on the CPU, 8 ``operatorhub_catalog(6, 2)``
    problems: every rank's lanes (outcome, installed set, core, steps,
    backtracks) equal each other and the one-process reference; the
    clause mode's rounds cross the processes, and no worker loads jax or
    deppy_tpu."""
    proc = subprocess.run(
        [sys.executable, "-m", "deppy_tpu_torch.parallel.dist_dryrun",
         "--device", "cpu", "--processes", "2", "--slots", "2", "--mode",
         mode, "--family", "catalog", "--packages", "6", "--versions", "2",
         "--problems", "8", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    v = _verdict(proc.stdout)
    assert v["ok"] is True and v["agree"] is True
    assert v["outcomes"] == v["reference"]
    assert len(v["outcomes"]) == 8
    assert [w["shards"] for w in v["workers"]] == [4, 4]
    assert all(w["forbidden"] == [] for w in v["workers"])
    if mode == "clause":
        rounds = {w["sharded_rounds"] for w in v["workers"]}
        assert len(rounds) == 1 and rounds.pop() > 0
        assert all(w["plain_rounds"] == 0 for w in v["workers"])
    else:
        assert all(w["sharded_rounds"] == 0 for w in v["workers"])


def test_initialize_distributed_is_a_noop_without_the_environment(
        monkeypatch):
    import torch.distributed as dist

    for k in tmesh._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    tmesh.initialize_distributed()
    assert not dist.is_initialized()
    with pytest.raises(TypeError):
        tmesh.initialize_distributed(coordinator="127.0.0.1:1")
    assert not dist.is_initialized()


def test_bad_coordinator_raises_within_its_timeout():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent(f"""
        import time
        from deppy_tpu_torch.parallel import initialize_distributed
        t0 = time.perf_counter()
        try:
            initialize_distributed(coordinator_address="127.0.0.1:{port}",
                                   num_processes=2, process_id=1,
                                   initialization_timeout=2)
        except Exception as e:
            print("RAISED", type(e).__name__, time.perf_counter() - t0)
        else:
            print("JOINED")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr[-2000:]
    assert float(proc.stdout.split()[-1]) < 30


def _stub_nvcc(tmp: Path, delay: float) -> str:
    """An ``nvcc`` that sleeps, then touches every ``-o`` target."""
    path = tmp / "nvcc"
    path.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        sleep {delay}
        while [ $# -gt 0 ]; do
          if [ "$1" = "-o" ]; then shift; : > "$1"; fi
          shift
        done
    """))
    path.chmod(0o755)
    return str(path)


def test_build_race_between_two_ranks_counts_as_built(tmp_path, monkeypatch):
    """Two ranks building at once: the one whose ``os.replace`` loses to
    a directory that already holds the library counts it as built."""
    monkeypatch.setattr(_build, "_nvcc", lambda: _stub_nvcc(tmp_path, 0.3))
    out_dir = tmp_path / "build" / "abc"
    out_dir.parent.mkdir()
    errors = []

    def build():
        try:
            _build._compile(out_dir)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert (out_dir / _build.LIB_NAME).exists()
    # Both temporary directories are gone: only the placed build remains.
    assert sorted(p.name for p in out_dir.parent.iterdir()) == ["abc"]


def test_build_race_loser_without_a_library_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: _stub_nvcc(tmp_path, 0.0))
    out_dir = tmp_path / "build" / "abc"
    out_dir.mkdir(parents=True)
    (out_dir / "stray").write_text("")
    with pytest.raises(OSError):
        _build._compile(out_dir)
    assert sorted(p.name for p in out_dir.parent.iterdir()) == ["abc"]
    assert os.listdir(out_dir) == ["stray"]
