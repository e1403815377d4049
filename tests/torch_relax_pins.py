"""The relaxed-arm runs of chip_smoke.py's phase 18, for either package.

(b) ``relax.solve_relaxed`` over Kueue's large-scale config without
preemption (bench.py's ``relax_arm`` shape: every workload pending, the
lean export padded to a power of two), beside the exact plan of the
unpadded export; (c) bench.py's churn loop through the production
router (bench.py:2053-2090) on bench's ``small`` shape, every relaxed
drain audited; (d) ``sim.solve_scenarios_relax`` over the first
scenarios of bench.py's whatif shape. Each run gives a record of plain
values that must be equal in the two packages.

The relaxed LP is float32 arithmetic, and XLA:CPU compiles it for the
host's instruction set: with FMA it fuses multiply-adds that the port
(and its CUDA kernel) round apart. The port follows the JAX program as
tier-1 compiles it, under tests/conftest.py's ``--xla_cpu_max_isa=AVX``
(no FMA). Run as a script, ``JAX_PLATFORMS=cpu python
tests/torch_relax_pins.py`` sets those flags before JAX loads and
prints the JAX package's records at full size in the form chip_smoke.py
pins them (a few minutes).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys
from pathlib import Path

#: tests/conftest.py's XLA flags, under which tier-1 runs the JAX package
CONFTEST_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                      "--xla_cpu_parallel_codegen_split_count=1 "
                      "--xla_cpu_max_isa=AVX")
if __name__ == "__main__":
    # before anything loads JAX
    os.environ["XLA_FLAGS"] = CONFTEST_XLA_FLAGS
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_scheduler_pins import committed_store_digest  # noqa: E402
from torch_sim_pins import (  # noqa: E402
    bench_whatif_problem,
    large_scale_config,
    plan_digest,
)

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _engine(root: str, store, queues, device: str):
    engine_mod = _mod(root, "solver.engine")
    if root == JAX:
        return engine_mod.SolverEngine(store, queues, mesh_mode="off")
    return engine_mod.SolverEngine(store, queues, device=device)


def large_scale_problems(root: str, per_cq=(35, 11, 4), n_cohorts=10,
                         cqs_per_cohort=100):
    """Kueue's large-scale config without preemption, every workload
    pending: (the unpadded lean export, the export padded to a power of
    two), exported by a fresh engine."""
    gen = _mod(root, "perf.generator")
    tensors = _mod(root, "solver.tensors")
    queues = _mod(root, "core.queue_manager")
    store, schedule = gen.generate(large_scale_config(
        gen, per_cq, n_cohorts, cqs_per_cohort))
    for g in schedule:
        store.add_workload(g.workload)
    engine = _engine(root, store, queues.QueueManager(store), "cpu")
    problem, _ = engine.export()
    return problem, tensors.pad_workloads(problem,
                                          tensors.pow2(problem.n_workloads))


def exact_plan(root: str, problem, device: str = "cpu") -> tuple:
    """The exact lean drain's plan of ``problem`` (numpy)."""
    kernels = _mod(root, "solver.kernels")
    if root == JAX:
        return tuple(np.asarray(a) for a in kernels.solve_backlog(
            kernels.to_device(problem)))
    return tuple(a.cpu().numpy() for a in kernels.solve_backlog(
        kernels.to_device(problem, device)))


def relax_arm_record(root: str, padded, exact, device: str = "cpu"
                     ) -> tuple[dict, object]:
    """``solve_relaxed`` on the padded export: the support (size and
    digest of its mask), the repair's rounds and padded width, the
    plan's admissions and digest, and ``plans_agree`` with ``exact``
    (the plan of the unpadded export: the real rows come first in
    both). Returns (record, stats)."""
    relax = _mod(root, "solver.relax")
    if root == JAX:
        plan, stats = relax.solve_relaxed(padded)
    else:
        plan, stats = relax.solve_relaxed(padded, device=device)
    lp = relax.build_lp(padded)
    sel = relax.rounded_support(stats.x, padded, lp.live)
    return {"live": stats.live, "support": stats.support,
            "support_padded": stats.support_padded,
            "support_digest": hashlib.sha256(
                np.ascontiguousarray(sel).tobytes()).hexdigest(),
            "repair_rounds": stats.repair_rounds,
            "admitted": int(np.asarray(plan[0]).sum()),
            "plan_digest": plan_digest(plan),
            "plans_agree": bool(relax.plans_agree(
                plan, exact, len(exact[0]) - 1))}, stats


class RelaxCounts:
    """The relaxed arm's counts of either package's engine since it was
    made: the port's ``relax_counts``, or the JAX metrics' deltas."""

    LABELS = ("served", "audit_match", "audit_diverged", "error")

    def __init__(self, root: str, engine) -> None:
        self.root, self.engine = root, engine
        self.base = self._read()

    def _read(self) -> dict:
        if self.root == PORT:
            c = self.engine.relax_counts
            return {**c["solver_relax_drains_total"],
                    **c["solver_fallback_total"]}
        metrics = _mod(JAX, "metrics")
        drains = metrics.solver_relax_drains_total.collect()
        falls = metrics.solver_fallback_total.collect()
        out = {k: int(drains.get((k,), 0)) for k in self.LABELS}
        out.update({k: int(falls.get((k,), 0))
                    for k in ("relax_error", "relax_disagreement")})
        return out

    def take(self) -> dict:
        now = self._read()
        return {k: now[k] - self.base[k] for k in now}


def churn_record(root: str, device: str = "cpu", n_cycles: int = 4,
                 n_cohorts: int = 2, cqs_per_cohort: int = 10,
                 per_cq=(35, 11, 4), audit_every: int = 1
                 ) -> tuple[dict, list]:
    """bench.py's relax churn (bench.py:2053-2090) on large_scale(
    preemption=False) at ``n_cohorts`` x ``cqs_per_cohort``: an engine
    with ``relax_force`` and ``relax_audit_every = audit_every`` and a
    host scheduler attached, ``drain(verify=True)``, then ``n_cycles``
    cycles of 32 finishes and 32 one-cpu arrivals, each followed by a
    drain. With ``audit_every = 1`` every drain is audited and commits
    the exact plan; with 3 the arm serves drains 2, 4 and 5 (its plan
    committed, the exact arm's resident state updated by the frame) and
    the exact solve of drain 3 reads that state. Returns (record, the
    drains' results)."""
    gen = _mod(root, "perf.generator")
    types = _mod(root, "api.types")
    queues_mod = _mod(root, "core.queue_manager")
    sched_mod = _mod(root, "scheduler.scheduler")
    store, schedule = gen.generate(large_scale_config(
        gen, per_cq, n_cohorts, cqs_per_cohort))
    for g in schedule:
        store.add_workload(g.workload)
    queues = queues_mod.QueueManager(store)
    engine = _engine(root, store, queues, device)
    sched = (sched_mod.Scheduler(store, queues) if root == JAX
             else sched_mod.Scheduler(store, queues, device=device))
    engine.scheduler = sched
    engine.relax_force = True
    engine.relax_audit_every = audit_every
    engine.pad_to = len(schedule) + 512
    counts = RelaxCounts(root, engine)
    if root == JAX:
        metrics = _mod(JAX, "metrics")
        rejected0 = metrics.solver_plan_fallbacks_total.total()
    results = [engine.drain(now=0.0, verify=True)]
    lqs = sorted({w.queue_name for w in store.workloads.values()})
    uid = max(w.uid for w in store.workloads.values()) + 1
    for c in range(1, n_cycles + 1):
        admitted = [k for k, w in store.workloads.items()
                    if w.is_quota_reserved and not w.is_finished]
        for k in admitted[:32]:
            sched.finish_workload(k, now=float(c))
        for j in range(32):
            i = uid + c * 32 + j
            store.add_workload(types.Workload(
                name=f"churn-{c}-{j}", queue_name=lqs[i % len(lqs)], uid=i,
                creation_time=1e6 + c * 32 + j,
                podsets=[types.PodSet(name="main", count=1,
                                      requests={"cpu": 1})]))
        results.append(engine.drain(now=float(c), verify=True))
    rejections = (int(metrics.solver_plan_fallbacks_total.total()
                      - rejected0) if root == JAX
                  else sum(r.plan_fallbacks for r in results))
    taken = counts.take()
    return {"drains": len(results),
            "admitted": [r.admitted for r in results],
            "audit_match": taken["audit_match"],
            "audit_diverged": taken["audit_diverged"],
            "served": taken["served"], "error": taken["error"],
            "oracle_rejections": rejections,
            "digest": committed_store_digest(store)}, results


def relax_tier_record(root: str, n_scenarios: int = 32,
                      device: str = "cpu") -> tuple[dict, object]:
    """``solve_scenarios_relax`` over the first ``n_scenarios`` of
    bench.py's whatif overlays: the stacked plans' digest and each
    scenario's admissions and rounds. Returns (record, result)."""
    sim = _mod(root, "sim")
    problem, overlays = bench_whatif_problem(root)
    overlays = overlays[:n_scenarios]
    if root == JAX:
        out = sim.solve_scenarios_relax(problem, overlays)
    else:
        out = sim.solve_scenarios_relax(problem, overlays, device=device)
    return {"scenarios": len(overlays),
            "plan_digest": plan_digest((out.admitted, out.opt,
                                        out.admit_round, out.parked,
                                        out.rounds, out.usage)),
            "admitted": [int(a.sum()) for a in out.admitted],
            "rounds": [int(r) for r in out.rounds]}, out


def reference_pins() -> dict:
    """The JAX package's records of phase 18 at full size."""
    import time

    out = {}
    t0 = time.monotonic()
    problem, padded = large_scale_problems(JAX)
    exact = exact_plan(JAX, problem)
    out["relax_arm"], _ = relax_arm_record(JAX, padded, exact)
    print(f"# relax arm {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    out["churn"], _ = churn_record(JAX)
    print(f"# churn {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    out["churn_served"], _ = churn_record(JAX, audit_every=3)
    print(f"# served churn {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    out["relax_tier"], _ = relax_tier_record(JAX)
    print(f"# tier {time.monotonic() - t0:.1f} s", file=sys.stderr)
    return out


def main() -> None:
    print(json.dumps(reference_pins(), indent=1))


if __name__ == "__main__":
    main()
