"""Launch counts of the CUDA kernels: one table that every wrapper feeds.

Each wrapper calls :func:`count` once where it launches its kernel, and
nowhere else.  A launch is keyed ``(kernel, impl, team, bank)``: the BCP
impl it ran under, the team that ran it (``"block"`` or ``"warp"``), and,
for a watched launch, whether it read a real clause bank (``"real"``) or
ran the dense rounds on dummy banks (``"dummy"``; None under every other
impl).  ``deppy_tpu_torch.engine`` derives its views from :data:`launches`
(``launch_counts``, ``warp_launch_counts``, ``impl_launch_counts``,
``bank_launch_counts``) and clears it in ``reset_launch_counts``.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

launches: Counter = Counter()


def count(kernel: str, impl: str, team: str, arm: Optional[object]) -> None:
    """Count one launch of ``kernel`` under ``impl`` on ``team``; a
    watched launch read a real bank when it ran the watched ``arm``."""
    bank = None
    if impl == "watched":
        bank = "real" if arm is not None else "dummy"
    launches[kernel, impl, team, bank] += 1


def total(kernel: str, impl: Optional[str] = None,
          team: Optional[str] = None, bank: Optional[str] = None) -> int:
    """Launches of ``kernel`` since the last reset, restricted to the
    given impl, team and bank where they are given."""
    return sum(n for (k, i, t, b), n in launches.items()
               if k == kernel and impl in (None, i) and team in (None, t)
               and bank in (None, b))
