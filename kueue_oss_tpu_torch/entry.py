"""Entry point of the port: the lean backlog drain over a small
synthetic admission problem.

The counterpart of ``__graft_entry__.py``'s ``entry()``: ``entry()``
returns ``(fn, example_args)``, here ``(kernels.solve_backlog,
(tensors,))`` with the problem's tensors on ``device`` ("cuda" unless
the caller asks for the CPU; it raises without CUDA), so ``fn(*args)``
runs one drain. Its ``dryrun_multichip`` waits for the multi-process
pod mesh (ROADMAP Queue A items 9b and 10).
"""

from __future__ import annotations


def _small_problem(n_cohorts: int = 2, cqs: int = 4, wl_per_cq: int = 8,
                   device="cuda"):
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.perf.generator import (
        GeneratorConfig,
        WorkloadClass,
        generate,
    )
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    config = GeneratorConfig(
        n_cohorts=n_cohorts,
        cqs_per_cohort=cqs,
        reclaim_within_cohort="Never",
        within_cluster_queue="Never",
        classes=[
            WorkloadClass("small", wl_per_cq - 2, 1, 50, 200, 0),
            WorkloadClass("large", 2, 20, 200, 1000, 0),
        ],
    )
    store, schedule = generate(config)
    for g in schedule:
        store.add_workload(g.workload)
    engine = SolverEngine(store, QueueManager(store), device=device)
    problem, _ = engine.export()
    return problem


def entry(device="cuda"):
    """The lean drain and its example arguments on ``device``."""
    from kueue_oss_tpu_torch.device import resolve_device
    from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device

    device = resolve_device(device)
    problem = _small_problem(device=device)
    return solve_backlog, (to_device(problem, device),)
