#!/usr/bin/env python3
"""Compare this tree with another checkout of the repository on one card,
in turns, in one run.

Run from the repository root, with the other tree unpacked in a git-ignored
directory (for example ``git archive HEAD~1 | tar -x -C checkout/parent``)::

    python3 chip_ab.py checkout/parent

Each of the four turns (other, this, this, other) is a fresh process that
builds that tree's kernels and prints one ``ab <tree>: ...`` line per
measurement:

* kernel 3 (the search kernel) on the 32 ``gvk_fleet`` lanes that
  ``chip_smoke.py`` compares it on, at T 0: the median of three profiled
  timings (``chip_smoke._timed``), and ``ptxas``'s registers, stack frame
  and spill bytes for ``search_kernel`` from that tree's build log;
* the walls of three consecutive ``BatchResolver(device="cuda").solve``
  calls on 1,000 ``version_pinned_chains(20, 3)`` under ``watched`` and
  1,000 ``pinned_tenant_catalog`` states under ``pallas``: a process's
  first call beside the calls after it.

Exits non-zero without a card.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import time


def _ptxas(lib_dir) -> str:
    """Registers, stack frame and spills of ``search_kernel`` in a build's
    ``ptxas.log``."""
    lines = (lib_dir / "ptxas.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "search_kernel" in line:
            tail = " ".join(lines[i + 1:i + 4])
            stack = re.search(r"(\d+) bytes stack frame", tail)
            stores = re.search(r"(\d+) bytes spill stores", tail)
            loads = re.search(r"(\d+) bytes spill loads", tail)
            regs = re.search(r"Used (\d+) registers", tail)
            return (f"registers {regs and regs.group(1)}, stack frame "
                    f"{stack and stack.group(1)} B, spill stores "
                    f"{stores and stores.group(1)} B, spill loads "
                    f"{loads and loads.group(1)} B")
    return "search_kernel not in the build log"


def turn(tree: str) -> None:
    """One tree's measurements, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from deppy_tpu_torch.engine import _build, core, cuda_search, driver
    from deppy_tpu_torch.models import (pinned_tenant_catalog,
                                        version_pinned_chains)
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat.encode import encode

    _build.load()
    print(f"ab {tree}: search_kernel {_ptxas(_build.library_path().parent)}",
          flush=True)
    name, count, make = cs.families(1.0)[0]
    probs = [encode(make(i)) for i in range(min(count, driver.MAX_LANES))]
    d = driver._Dims(probs, len(probs))
    lanes = probs[:cs.COMPARE_LANES]
    dev = torch.device("cuda")
    pts = driver._upload(driver.pad_stack(lanes, d, len(lanes)), dev)
    red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
    en = torch.ones(len(lanes), dtype=torch.bool, device=dev)
    budget = driver.DEFAULT_MAX_STEPS
    ms = [cs._timed(lambda: cuda_search.batched_search_fused(red, budget,
                                                            en),
                    "search", cs.TIMED_REPS)[1] for _ in range(3)]
    print(f"ab {tree}: kernel search on {name} ({len(lanes)} lanes, T 0): "
          f"ms {statistics.median(ms):.6f} (runs {ms})", flush=True)

    pools = (("watched", "chains",
              [version_pinned_chains(20, 3, seed=i) for i in range(1000)]),
             ("pallas", "pinned_tenant",
              [pinned_tenant_catalog(seed=i) for i in range(1000)]))
    for impl, family, pool in pools:
        core.set_bcp_impl(impl)
        try:
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                BatchResolver(device="cuda").solve(pool)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        finally:
            core.set_bcp_impl("auto")
        print(f"ab {tree}: {family} under {impl}, walls of three calls "
              f"{[round(w, 4) for w in walls]} s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--turn":
        turn(argv[1])
        return 0
    if len(argv) != 1:
        print("usage: python3 chip_ab.py OTHER_TREE", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(f"card: {card.stdout.strip()}", flush=True)
    other = argv[0]
    for tree in (other, ".", ".", other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
