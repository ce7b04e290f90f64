#!/usr/bin/env python3
"""Where the cycles of the warp team's phase-3 kernel go, on one NVIDIA card.

Run from the repository root, with one card visible::

    python3 chip_cycles.py

It copies ``deppy_tpu_torch`` into ``build/cycles/`` (git-ignored), adds
``clock64()`` counters to that copy's ``csrc/warp.cuh`` and
``csrc/core.cu`` (the repository's sources are not touched), builds it,
and runs phase 3 (``batched_core_fused`` under the warp team) on the 32
``pinned_tenant_catalog`` lanes ``chip_smoke.py`` times it on.  Lane 0 of
every eighth warp prints, for its problem: the kernel's cycles, the
fixpoint calls and rounds (which equal the plain version's), the cycles
inside
fixpoints and inside rounds, and the round's parts: the shuffles of the
entry state, the clause rows, the AtMost rows, the first flag reduction,
and the rest (the per-word reductions, the apply and the second flag
reduction, when a round forced a literal).  The counters slow the
kernel, and their cycles are counted in.  The warp team's outputs are
held against the block team's on the same inputs; any difference fails
the run.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "cycles"

# The counters: (text in the source, text it becomes).  Each must be found
# exactly once, so an edit of the kernels that moves them fails loudly.
WARP_EDITS = [
    ("constexpr unsigned kFullMask = 0xffffffffu;",
     "constexpr unsigned kFullMask = 0xffffffffu;\n"
     "__device__ long long g_cycles[4096][10];\n"
     "#define CYCLES_ADD(k, v) do { if ((threadIdx.x & 31) == 0) "
     "g_cycles[blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)][k] "
     "+= (v); } while (0)"),
    ("  const int NA = P.NA;\n  // Row activity from the entry state",
     "  const int NA = P.NA;\n  const long long fx0 = clock64();\n"
     "  CYCLES_ADD(0, 1);\n  // Row activity from the entry state"),
    ("  while (go) {\n    // The round's entry state",
     "  while (go) {\n    const long long q0 = clock64();\n"
     "    CYCLES_ADD(1, 1);\n    // The round's entry state"),
    ("    int mtrues = 0;\n",
     "    const long long q1 = clock64();\n    CYCLES_ADD(4, q1 - q0);\n"
     "    int mtrues = 0;\n"),
    ("    // AtMost rows: more than n true members",
     "    const long long q2 = clock64();\n    CYCLES_ADD(5, q2 - q1);\n"
     "    // AtMost rows: more than n true members"),
    ("    // Whether any literal is forced",
     "    const long long q3 = clock64();\n    CYCLES_ADD(6, q3 - q2);\n"
     "    // Whether any literal is forced"),
    ("    go = false;\n    if (pre_flags & 2u) {",
     "    go = false;\n    const long long q4 = clock64();\n"
     "    CYCLES_ADD(7, q4 - q3);\n    if (pre_flags & 2u) {"),
    ("      go = !conflict && (flags & 2u) != 0u;\n    }\n  }\n"
     "  return conflict || pre;",
     "      go = !conflict && (flags & 2u) != 0u;\n    }\n"
     "    const long long q5 = clock64();\n    CYCLES_ADD(8, q5 - q4);\n"
     "    CYCLES_ADD(3, q5 - q0);\n  }\n  CYCLES_ADD(2, clock64() - fx0);\n"
     "  return conflict || pre;"),
]
CORE_EDITS = [
    ("#include <cuda_runtime.h>", "#include <cuda_runtime.h>\n#include <cstdio>"),
    ("  if (b >= B) return;  // the whole warp: no block barrier follows\n"
     "  const bool en = en_in[b] != 0;\n  const int n_cons = ncons_in[b];",
     "  if (b >= B) return;  // the whole warp: no block barrier follows\n"
     "  const long long k0 = clock64();\n"
     "  if (lane == 0) for (int i = 0; i < 10; ++i) g_cycles[b][i] = 0;\n"
     "  __syncwarp();\n  const bool en = en_in[b] != 0;\n"
     "  const int n_cons = ncons_in[b];"),
    ("  if (lane == 0) steps_out[b] = steps;\n}",
     "  if (lane == 0) steps_out[b] = steps;\n"
     "  if (lane == 0 && b % 8 == 7) {\n"
     "    const long long* g = g_cycles[b];\n"
     "    printf(\"cycles lane %d W %d kernel %lld calls %lld rounds %lld "
     "in_fixpoints %lld in_rounds %lld shuffles %lld clause_rows %lld "
     "atmost_rows %lld first_flags %lld rest %lld steps %d\\n\", b, W, "
     "clock64() - k0, g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], "
     "g[8], steps - steps_in[b]);\n  }\n}"),
]

MEASURE = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import deppy_tpu_torch
from deppy_tpu_torch.engine import _build, core, cuda_search, driver
from deppy_tpu_torch.models import pinned_tenant_catalog
from deppy_tpu_torch.sat.encode import encode
assert deppy_tpu_torch.__file__.startswith(sys.argv[1])
_build.load()
dev = torch.device("cuda")
probs = [encode(pinned_tenant_catalog(seed=i)) for i in range(512)]
d = driver._Dims(probs, len(probs))
pts = driver._upload(driver.pad_stack(probs[:32], d, 32), dev)
red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
full = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
en = torch.ones(32, dtype=torch.bool, device=dev)
budget = driver.DEFAULT_MAX_STEPS
result, _, _, steps = cuda_search.batched_search_fused(red, budget, en)[:4]
unsat = en & (result == core.UNSAT)
args = (full, budget, steps, unsat)
block = cuda_search.batched_core_fused(*args, NCON=d.NCON, _team="block")
warp = cuda_search.batched_core_fused(*args, NCON=d.NCON, _team="warp")
torch.cuda.synchronize()
bad = sum(int((x != y).sum()) for x, y in zip(block, warp))
print(f"warp against block on {int(unsat.sum())} UNSAT lanes: mismatches {bad}",
      flush=True)
sys.exit(1 if bad else 0)
'''


def instrumented_copy() -> Path:
    """The package copied under build/cycles/ with the counters added."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "deppy_tpu_torch", COPY / "deppy_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = COPY / "deppy_tpu_torch" / "engine" / "csrc"
    for name, edits in (("warp.cuh", WARP_EDITS), ("core.cu", CORE_EDITS)):
        text = (csrc / name).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"chip_cycles: {name} no longer holds "
                                   f"{old[:60]!r} exactly once")
            text = text.replace(old, new)
        (csrc / name).write_text(text)
    return COPY


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_cycles: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    copy = instrumented_copy()
    # A process of its own, so that the copy is the only deppy_tpu_torch.
    return subprocess.run([sys.executable, "-c", MEASURE, str(copy)],
                          timeout=900).returncode


if __name__ == "__main__":
    sys.exit(main())
