"""What-if engine: batched counterfactual simulation & capacity
planning (a copy of the lean path of ``kueue_oss_tpu/sim``).

Public surface:

- :class:`ScenarioSpec` / sweep constructors (scenario layer);
- :class:`WhatIfEngine` / :func:`simulate_trace` (execution);
- :func:`solve_scenarios` / :func:`solve_scenarios_sequential`
  (batched solve layer, for direct tensor-level use);
- :class:`WhatIfReport` (report layer);
- :func:`solve_scenarios_relax` (the relax tier of the FULL sweeps,
  returning a :class:`FullSweepResult`).

Not ported yet: the FULL-kernel sweeps' FULL tier and tiered dispatch,
``ResidentSweep``, dispatch pricing, traces and journal replay (ROADMAP
Queue A item 7b).
"""

from kueue_oss_tpu_torch.sim.batch import (  # noqa: F401
    BatchSolveResult,
    FullSweepResult,
    check_parity,
    solve_scenarios,
    solve_scenarios_relax,
    solve_scenarios_sequential,
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
from kueue_oss_tpu_torch.sim.scenario import (  # noqa: F401
    FlapEvent,
    ScenarioSpec,
    arrival_sweep,
    cross,
    quota_sweep,
)
