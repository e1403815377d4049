"""Performance harness: synthetic cluster/workload generator + simulator.

A copy of ``kueue_oss_tpu/perf`` on the port. Reference parity:
test/performance/scheduler/{minimalkueue,runner} — a generator builds
cohorts/CQs/workload classes from a config, a runner fakes workload
execution (finish after runtime_ms) and collects admission stats
(wall time, per-class time-to-admission, throughput, CQ usage), and a
checker holds them to the rangespec thresholds.
"""

from kueue_oss_tpu_torch.perf.checker import (  # noqa: F401
    BASELINE_SPEC,
    RangeSpec,
    check,
)
from kueue_oss_tpu_torch.perf.generator import (  # noqa: F401
    GeneratedWorkload,
    GeneratorConfig,
    WorkloadClass,
    generate,
)
from kueue_oss_tpu_torch.perf.runner import (  # noqa: F401
    SimStats,
    Simulator,
    drain_benchmark,
)
