"""The perf-runner and what-if runs of chip_smoke.py's phases 16-17, for
either package.

Phase 16 drives ``perf.runner.Simulator`` over Kueue's baseline
generator config host-only (a) and with ``solver="auto"`` (b), and
``drain_benchmark`` over the large-scale config (c); phase 17 runs the
lean what-if sweep: bench.py's ``whatif`` shape through
``solve_scenarios`` (a) and ``WhatIfEngine.run`` on the baseline
backlog (b). Each run gives a record of plain values that must be equal
in the two packages.

``solver="auto"`` routes between device drains and host cycles by
wall-clock cost EMAs, so a run would route differently on every
machine. ``pin_cost_gates`` resets both EMAs to None before every
routing decision (a wrapper on the scheduler instance), so the
count-based gate decides in both packages. The JAX side's auto
scheduler is its ``Scheduler`` over a JAX ``SolverEngine`` built with
``mesh_mode="off"`` and ``scheduler=`` that scheduler.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_sim_pins.py``,
it prints the JAX package's records at full size in the form
chip_smoke.py pins them (a few minutes).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_scheduler_pins import CountedDrains  # noqa: E402
from torch_streaming_pins import timed_store_digest  # noqa: E402

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"

#: the what-if grid of phase 17 (b): 8 quota worlds x 4 arrival worlds
WHATIF_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
WHATIF_ARRIVAL = (0.25, 0.5, 0.75)
#: the depth of phase 16 (b)'s auto run (chip_smoke.py PERF_AUTO_SCALE)
PERF_AUTO_SCALE = 0.25
#: bench.py's whatif sweep (bench.py:1465-1497)
BENCH_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
BENCH_ARRIVAL = (0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0)


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def pin_cost_gates(sched) -> None:
    """Reset the scheduler's two routing cost EMAs before every routing
    decision, so the count-based gate routes (deterministic)."""
    inner = sched._solver_drain

    def solver_drain(now):
        sched._drain_cost_ema = None
        sched._host_s_per_adm = None
        return inner(now)

    sched._solver_drain = solver_drain


def plan_digest(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes (a drain's plan
    tuple, or a batch's stacked plans); either package's arrays."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if hasattr(a, "cpu") else a
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def baseline_config(gen, scale: float = 1.0, n_cohorts: int = 5,
                    cqs_per_cohort: int = 6):
    """Kueue's baseline generator config (5 x 6 ClusterQueues, 350 /
    100 / 50 small / medium / large per ClusterQueue), the per-class
    counts scaled by ``scale``."""
    cfg = gen.GeneratorConfig.baseline()
    cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs_per_cohort
    for wc in cfg.classes:
        wc.count = max(1, round(wc.count * scale))
    return cfg


def make_simulator(root: str, store, schedule, solver: bool,
                   device: str = "cpu"):
    """A Simulator of either package; with ``solver`` its scheduler
    drains on the device (JAX: over a ``mesh_mode="off"`` engine) with
    the cost gates pinned."""
    runner = _mod(root, "perf.runner")
    if root == JAX:
        sim = runner.Simulator(store, schedule)
        if solver:
            engine = _mod(JAX, "solver.engine").SolverEngine(
                store, sim.queues, scheduler=sim.scheduler,
                mesh_mode="off")
            engine.pad_to = len(schedule)
            sim.scheduler.solver = engine
    else:
        sim = runner.Simulator(store, schedule,
                               solver="auto" if solver else None,
                               device=device)
    if solver:
        pin_cost_gates(sim.scheduler)
        # the relaxed arm routes by wall clock too: pinned off
        sim.scheduler._solver_engine().relax_enabled = False
    return sim


def sim_record(root: str, cfg, solver: bool, device: str = "cpu",
               min_backlog=None) -> dict:
    """Run ``Simulator(*generate(cfg))`` and record its SimStats (walls
    excluded), the committed-store digest with the QuotaReserved times
    and the device drains."""
    gen = _mod(root, "perf.generator")
    tensors = _mod(root, "solver.tensors")
    store, schedule = gen.generate(cfg)
    sim = make_simulator(root, store, schedule, solver, device)
    if min_backlog is not None:
        sim.scheduler.solver_min_backlog = min_backlog
    drains = None
    if solver:
        drains = CountedDrains(sim.scheduler._solver_engine(),
                               tensors.UnsupportedProblem)
    stats = sim.run()
    rec = {"admitted": stats.admitted, "finished": stats.finished,
           "preemptions": stats.preemptions, "cycles": stats.cycles,
           "sim_wall_ms": stats.sim_wall_ms,
           "tta_ms_by_class": dict(sorted(stats.tta_ms_by_class.items())),
           "digest": timed_store_digest(store)}
    if drains is not None:
        rec.update(drains.take())
    return rec, stats, sim


def drain_bench_record(root: str, cfg, device: str = "cpu") -> dict:
    """``drain_benchmark`` on a generated store, beside the digest of
    the plan its solve computes (the JAX side re-solves its export;
    the port side records the solve's own output)."""
    gen = _mod(root, "perf.generator")
    runner = _mod(root, "perf.runner")
    kernels = _mod(root, "solver.kernels")
    store, schedule = gen.generate(cfg)
    if root == JAX:
        out = runner.drain_benchmark(store, schedule)
        engine = _mod(JAX, "solver.engine").SolverEngine(
            store, _mod(JAX, "core.queue_manager").QueueManager(store),
            mesh_mode="off")
        problem, _ = engine.export()
        plan = kernels.solve_backlog(kernels.to_device(problem))
    else:
        plans = []
        inner = kernels.solve_backlog

        def solve(t):
            plans.append(inner(t))
            return plans[-1]

        kernels.solve_backlog = solve
        try:
            out = runner.drain_benchmark(store, schedule, device=device)
        finally:
            kernels.solve_backlog = inner
        (plan,) = plans
    return {"workloads": out["workloads"],
            "cluster_queues": out["cluster_queues"],
            "admitted": out["admitted"], "rounds": out["rounds"],
            "plan_digest": plan_digest(plan)}, out


def large_scale_config(gen, per_cq: tuple = (35, 11, 4),
                       n_cohorts: int = 10, cqs_per_cohort: int = 100):
    """Kueue's large-scale config without preemption (10 x 100
    ClusterQueues, 35 / 11 / 4 workloads per ClusterQueue)."""
    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs_per_cohort
    for wc, n in zip(cfg.classes, per_cq):
        wc.count = n
    return cfg


def bench_whatif_problem(root: str, n_scenarios: int = 128):
    """bench.py's whatif shape: large_scale(preemption=False) cut to
    2 x 4 ClusterQueues with 14 / 4 / 2 workloads each (W = 160, padded
    to 256), and ``n_scenarios`` of its quota x arrival grid, tiled, as
    overlays with ``replicas=1``. Returns (problem, overlays)."""
    gen = _mod(root, "perf.generator")
    sim = _mod(root, "sim")
    tensors = _mod(root, "solver.tensors")
    queues = _mod(root, "core.queue_manager")
    cfg = large_scale_config(gen, (14, 4, 2), n_cohorts=2,
                             cqs_per_cohort=4)
    store, schedule = gen.generate(cfg)
    for g in schedule:
        store.add_workload(g.workload)
    pending = sim.pending_backlog(store, queues.QueueManager(store))
    problem = tensors.export_problem(
        store, pending, cache=tensors.ExportCache(store, subscribe=False))
    problem = tensors.pad_workloads(problem,
                                    tensors.pow2(problem.n_workloads))
    specs = sim.cross(sim.quota_sweep(BENCH_QUOTA),
                      sim.arrival_sweep(BENCH_ARRIVAL))
    specs = (specs * (n_scenarios // len(specs) + 1))[:n_scenarios]
    return problem, [s.overlay(problem, replicas=1) for s in specs]


def batch_record(batch) -> dict:
    """The stacked plans of a BatchSolveResult: digest, rounds and
    admissions per scenario."""
    return {"plan_digest": plan_digest(
                (batch.admitted, batch.opt, batch.admit_round,
                 batch.parked, batch.rounds, batch.usage)),
            "rounds": [int(r) for r in batch.rounds],
            "admitted": [int(a.sum()) for a in batch.admitted]}


def whatif_baseline_specs(root: str):
    sim = _mod(root, "sim")
    return sim.cross(sim.quota_sweep(WHATIF_QUOTA),
                     sim.arrival_sweep(WHATIF_ARRIVAL))


def whatif_baseline_store(root: str, scale: float = 1.0, **kw):
    """Kueue's baseline backlog, every workload pending at t0."""
    gen = _mod(root, "perf.generator")
    store, schedule = gen.generate(baseline_config(gen, scale, **kw))
    for g in schedule:
        store.add_workload(g.workload)
    return store


def report_record(report) -> dict:
    """A WhatIfReport's canonical digest, its scenarios' rounds and
    admissions, and its dispatch shape."""
    return {"canonical_sha256": hashlib.sha256(
                report.canonical_json().encode()).hexdigest(),
            "rounds": [s["rounds"] for s in report.scenarios],
            "admitted": [s["admitted"] for s in report.scenarios],
            "parity": report.parity,
            "batch_dispatches": report.timing["batch_dispatches"],
            "round_buckets": report.timing["round_buckets"]}


def reference_pins() -> dict:
    """The JAX package's records of phases 16-17 at full size."""
    import time

    gen = _mod(JAX, "perf.generator")
    sim = _mod(JAX, "sim")
    checker = _mod(JAX, "perf.checker")
    out = {}
    t0 = time.monotonic()
    host, stats, _ = sim_record(JAX, baseline_config(gen), solver=False)
    host["check"] = checker.check(stats, checker.BASELINE_SPEC)
    out["sim_host"] = host
    print(f"# sim host {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    out["sim_auto"], _, _ = sim_record(
        JAX, baseline_config(gen, PERF_AUTO_SCALE), solver=True)
    print(f"# sim auto {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    out["drain_large"], _ = drain_bench_record(JAX, large_scale_config(gen))
    print(f"# drain {time.monotonic() - t0:.1f} s", file=sys.stderr)
    problem, overlays = bench_whatif_problem(JAX)
    out["whatif_bench"] = batch_record(
        sim.solve_scenarios(problem, overlays))
    t0 = time.monotonic()
    report = sim.WhatIfEngine(whatif_baseline_store(JAX)).run(
        whatif_baseline_specs(JAX))
    out["whatif_baseline"] = report_record(report)
    print(f"# whatif {time.monotonic() - t0:.1f} s", file=sys.stderr)
    return out


def main() -> None:
    print(json.dumps(reference_pins(), indent=1))


if __name__ == "__main__":
    main()
