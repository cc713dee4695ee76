"""Per-stage host timing (the port's own copy of ``StageTimer`` from
``fealess_tpu.utils.profiling``).

:class:`StageTimer` accumulates host seconds per named stage for the
CLI's ``--profile`` report, the structured analog of the reference's
``printTimeOfICP`` (ICP/ICP.cpp:283-311).  Device timing in the port uses
CUDA events and ``torch.profiler`` (``apps/profile_reco.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.calls if self.calls else 0.0


class StageTimer:
    """Accumulating per-stage stopwatch: ``add(name, seconds)`` per call,
    ``report()`` the table."""

    def __init__(self):
        self._stats: Dict[str, StageStats] = {}
        self._order: List[str] = []

    def add(self, name: str, seconds: float) -> None:
        if name not in self._stats:
            self._stats[name] = StageStats()
            self._order.append(name)
        self._stats[name].calls += 1
        self._stats[name].total_s += seconds

    def report(self) -> str:
        """printTimeOfICP-style table (ICP/ICP.cpp:283-311)."""
        lines = [f"{'stage':<24}{'calls':>8}{'total ms':>12}{'mean ms':>10}"]
        for name in self._order:
            s = self._stats[name]
            lines.append(f"{name:<24}{s.calls:>8}{1e3 * s.total_s:>12.2f}"
                         f"{s.mean_ms:>10.3f}")
        return "\n".join(lines)
