"""Performance-run checker (a copy of ``kueue_oss_tpu/perf/checker.py``).

Reference parity: test/performance/scheduler/checker + the rangespec.yaml
threshold files — asserts a perf run's stats against recorded thresholds
(max wall time, per-class time-to-admission ceilings, minimum throughput)
and reports violations instead of pass/fail booleans so CI logs show every
breach at once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_oss_tpu_torch.perf.runner import SimStats


@dataclass
class RangeSpec:
    """Threshold file analog (configs/*/rangespec.yaml)."""

    #: total simulated wall-clock ceiling (cmd.maxWallMs)
    max_wall_ms: Optional[float] = None
    #: class name -> average time-to-admission ceiling (ms)
    max_tta_ms_by_class: dict[str, float] = field(default_factory=dict)
    #: every generated workload must finish admitted
    require_all_admitted: bool = True
    #: minimum real-time admission throughput (admissions/s)
    min_admissions_per_second: Optional[float] = None


def check(stats: SimStats, spec: RangeSpec) -> list[str]:
    """Returns the list of threshold violations (empty = pass)."""
    violations: list[str] = []
    if spec.max_wall_ms is not None and stats.sim_wall_ms > spec.max_wall_ms:
        violations.append(
            f"wall time {stats.sim_wall_ms:.0f}ms exceeds "
            f"{spec.max_wall_ms:.0f}ms")
    for cls, ceiling in spec.max_tta_ms_by_class.items():
        tta = stats.tta_ms_by_class.get(cls)
        if tta is None:
            violations.append(f"class {cls!r}: no TTA recorded")
        elif tta > ceiling:
            violations.append(
                f"class {cls!r}: avg TTA {tta:.0f}ms exceeds {ceiling:.0f}ms")
    if spec.require_all_admitted and stats.admitted < stats.total_workloads:
        violations.append(
            f"only {stats.admitted}/{stats.total_workloads} admitted")
    if (spec.min_admissions_per_second is not None
            and stats.admissions_per_real_second
            < spec.min_admissions_per_second):
        violations.append(
            f"throughput {stats.admissions_per_real_second:.1f}/s below "
            f"{spec.min_admissions_per_second:.1f}/s")
    return violations


#: thresholds derived from the reference's baseline rangespec
#: (test/performance/scheduler/configs/baseline/rangespec.yaml, scaled to
#: the generator's default 5x6x500 = 15k-workload shape — wall 425s,
#: TTA ceilings 11s/90s/260s for large/medium/small)
BASELINE_SPEC = RangeSpec(
    max_wall_ms=425_000,
    max_tta_ms_by_class={"large": 11_000, "medium": 90_000,
                         "small": 260_000},
    require_all_admitted=True,
    # the reference implies ~43 adm/s; we require at least parity in
    # real time on the simulator
    min_admissions_per_second=43.0,
)
