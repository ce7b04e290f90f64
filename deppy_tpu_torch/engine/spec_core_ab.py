"""The speculative core sweep's A/B (port of ``scripts/spec_core_ab.py``, with the verdict rule of ``scripts/tpu_revalidate.py:115-131`` and its record, ``:405-429``).

``driver.SPEC_CORE`` "auto" turns the sweep on only where the
measured-defaults registry holds a ``spec_core`` row of "on"; this A/B
writes that row.  It solves ``giant_pinned_conflict(packages, versions,
seed=0)`` (a 3-constraint core buried in ~1.7k constraints at the
defaults, the workload the sweep was built for) end to end through
:class:`deppy_tpu_torch.sat.Solver`, with the sweep OFF first (the host
sweep answers the core), then ON (kernels 7 and 8 answer it), each solve
timed with ``time.perf_counter`` around ``Solver.solve()``.  The cores
must agree: the rendered ``NotSatisfiable`` messages are compared, and
a SAT answer on both arms is not agreement (the workload is UNSAT by
construction).  It prints one verdict line ``{"verdict",
"cores_agree", "off_s", "on_s"}`` and exits 1 on a divergence.

``--record`` writes the verdict as the reference's ladder does:
``{"spec_core": "on"}`` only when the cores agree and ``on_s <
off_s``, ``"off"`` on an agreeing loss, nothing on a divergence, through
``defaults.merge_rows("gpu", ...)`` with the evidence
``spec_core_on_s`` and ``spec_core_off_s``.  It records only at the
full shape (250, 8) on a card, as the ladder never records from a smoke
shape.

One difference from the reference: the arms run in turns in ONE process.
The reference gives each arm its own subprocess and a health probe
between them, to guard against a TPU worker crash that buries the
second arm; the card has no such crash, and a child process costs 7-12
s to reach it.  So both arms share the process: the kernels are built
and the card initialised before the first arm, and the BCP impl is
reset to ``auto`` for both (the reference scrubs the engine knobs from
both arms' environments), then restored.

Run::

    python -m deppy_tpu_torch.engine.spec_core_ab [--packages 250]
        [--versions 8] [--device cuda|cpu] [--record] [--registry PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Tuple

FULL_SHAPE = (250, 8)
# What an arm reports when the solve answers SAT.
SAT_SENTINEL = "<SAT?!>"


def solve_arm(packages: int, versions: int, device: str,
              spec: str) -> Tuple[str, float]:
    """One arm: (the rendered core, or :data:`SAT_SENTINEL`; seconds of
    ``Solver.solve()``) with ``driver.SPEC_CORE`` set to ``spec``."""
    from .. import sat
    from ..models import giant_pinned_conflict
    from . import driver

    saved = driver.SPEC_CORE
    driver.SPEC_CORE = spec
    try:
        vs = giant_pinned_conflict(n_packages=packages,
                                   versions_per_package=versions, seed=0)
        solver = sat.Solver(vs, device=device)
        t0 = time.perf_counter()
        try:
            solver.solve()
            core = SAT_SENTINEL
        except sat.NotSatisfiable as e:
            core = str(e)
        return core, time.perf_counter() - t0
    finally:
        driver.SPEC_CORE = saved


def verdict(off_core: Optional[str], on_core: Optional[str], off_s: float,
            on_s: float) -> dict:
    """The verdict line (spec_core_ab.py:109-120)."""
    agree = (off_core is not None and SAT_SENTINEL not in off_core
             and off_core == on_core)
    return {"verdict": "ok" if agree else "CORE-DIVERGENCE",
            "cores_agree": agree, "off_s": off_s, "on_s": on_s}


def records(packages: int, versions: int, device: str) -> bool:
    """Whether an A/B of this shape on this device may record: the full
    shape on a card only (tpu_revalidate.py:419-421)."""
    return (packages, versions) == FULL_SHAPE and device == "cuda"


def spec_core_row(rec: dict) -> Optional[str]:
    """The row a verdict line records (tpu_revalidate.py:115-131): "on"
    when the cores agree and ON won on time, "off" on an agreeing loss,
    None on a divergence or without both times."""
    if rec.get("verdict") != "ok":
        return None
    on_s, off_s = rec.get("on_s"), rec.get("off_s")
    if isinstance(on_s, (int, float)) and isinstance(off_s, (int, float)):
        return "on" if on_s < off_s else "off"
    return None


def record(rec: dict, path: Optional[str] = None) -> Optional[str]:
    """Write the verdict's row for the ``gpu`` platform
    (tpu_revalidate.py:423-429) and drop the memoized registry; returns
    the row written, or None when the verdict records nothing."""
    from . import defaults

    row = spec_core_row(rec)
    if row is None:
        return None
    defaults.merge_rows("gpu", {"spec_core": row},
                        {"spec_core_on_s": rec.get("on_s"),
                         "spec_core_off_s": rec.get("off_s")}, path=path)
    defaults.reload_measured_defaults()
    return row


def run(packages: int, versions: int, device: str) -> dict:
    """Both arms, OFF first, then the verdict line."""
    import torch

    from . import _build, core, driver

    dev = driver.resolve_device(device)
    if dev.type == "cuda":
        _build.load()
        torch.zeros(1, device=dev)
    impl = core._BCP_IMPL
    core.set_bcp_impl("auto")
    try:
        off_core, off_s = solve_arm(packages, versions, device, "0")
        on_core, on_s = solve_arm(packages, versions, device, "1")
    finally:
        core.set_bcp_impl(impl)
    return verdict(off_core, on_core, off_s, on_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", type=int, default=FULL_SHAPE[0])
    ap.add_argument("--versions", type=int, default=FULL_SHAPE[1])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--record", action="store_true",
                    help="write the verdict into the measured-defaults "
                         "registry (full shape on a card only)")
    ap.add_argument("--registry", default=None,
                    help="registry path (default: DEPPY_GPU_MEASURED_"
                         "DEFAULTS, else the package-local file)")
    a = ap.parse_args(argv)
    rec = run(a.packages, a.versions, a.device)
    print(json.dumps(rec), flush=True)
    if a.record:
        if not records(a.packages, a.versions, a.device):
            print(json.dumps({"recorded": None, "reason": "the registry "
                              "records the full shape on a card only"}),
                  flush=True)
        else:
            print(json.dumps({"recorded": record(rec, a.registry)}),
                  flush=True)
    return 0 if rec["cores_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
