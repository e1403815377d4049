"""What-if engine: batched counterfactual simulation & capacity
planning (a copy of ``kueue_oss_tpu/sim``).

Public surface:

- :class:`ScenarioSpec` / sweep constructors (scenario layer);
- :class:`WhatIfEngine` / :func:`simulate_trace` (execution);
- :func:`solve_scenarios` / :func:`solve_scenarios_sequential`
  (batched solve layer, for direct tensor-level use);
- FULL-kernel sweeps: :class:`LaneBudget` /
  :func:`solve_scenarios_tiered` / the sequential FULL oracle
  (lane-budgeted preemption-aware batching) and the relax tier
  :func:`solve_scenarios_relax`;
- :class:`ResidentSweep` (scenario-resident device state);
- traces: Philly/Helios-shaped generators, CSV/JSONL import, and the
  :func:`load_ladder` breaking-point sweep;
- :class:`WhatIfReport` (report layer).

Not ported yet: dispatch pricing and journal replay.
"""

from kueue_oss_tpu_torch.sim.batch import (  # noqa: F401
    BatchSolveResult,
    FullSweepResult,
    LaneBudget,
    check_parity,
    check_parity_full,
    full_caps,
    solve_scenarios,
    solve_scenarios_full,
    solve_scenarios_relax,
    solve_scenarios_sequential,
    solve_scenarios_sequential_full,
    solve_scenarios_tiered,
    sweep_order,
)
from kueue_oss_tpu_torch.sim.engine import (  # noqa: F401
    WhatIfEngine,
    pending_backlog,
    simulate_trace,
)
from kueue_oss_tpu_torch.sim.report import (  # noqa: F401
    WhatIfReport,
    borrow_stats,
    scenario_kpis,
)
from kueue_oss_tpu_torch.sim.resident import ResidentSweep  # noqa: F401
from kueue_oss_tpu_torch.sim.scenario import (  # noqa: F401
    FlapEvent,
    ScenarioSpec,
    arrival_sweep,
    cross,
    quota_sweep,
)
from kueue_oss_tpu_torch.sim.traces import (  # noqa: F401
    TraceJob,
    helios_trace,
    load_ladder,
    load_trace,
    philly_trace,
    save_trace,
    store_from_trace,
    synthetic_trace,
)
