"""The solver sidecar's runs of chip_smoke.py's phase 21, for either
package.

Phase 21 (c) is bench.py's ``chaos`` scenario (bench.py:604-700), not
cut: 8 ClusterQueues of 32 cpu, 1,024 one-cpu workloads, a
``ChaosSolverServer`` whose ``FaultInjector`` runs the schedule
[crash, garble, corrupt_plan] and then the seeded weighted mix {crash:
2, garble: 1, truncate: 1, corrupt_plan: 1, ok: 3} (seed 42), and a
``Scheduler(solver_min_backlog=64)`` over a ``SolverEngine`` whose
``SolverClient`` has a 30 s deadline, one retry and a 10 ms backoff
base; ``run_until_quiet(now=0.0, tick=1.0)``. That run reaches one
drain (crash, then garble on its one retry) before host cycles fill
every seat, so the phase goes on, as bench.py does not, with
``CHAOS_CHURN`` churn rounds on the same server and injector: each
finishes the first ``CHAOS_FINISH`` holders (sorted keys), resets the
scheduler's cost gates and its drained-once mark (so the round drains:
the count-based gate the JAX pins ran) and runs ``run_until_quiet(now=
100 + round, tick=1.0)``; the injector's schedule goes on into its
corrupt plan and the weighted mix. The record: the seats held after the
storm and after each round, the host cycles, the injected faults by
kind, the rejected plans, the backend errors, the wire frames and the
committed-store digest.

Every function takes the package name (``JAX`` or ``PORT``) and, on the
port, the device. The JAX sidecar runs without its mesh
(``server.mesh = None``, as a sidecar on one device) and its engine with
``mesh_mode="off"``, so both packages' sidecars answer
``mesh_devices`` 0 and pad alike. tests/test_torch_chaos_solver.py runs
both packages through ``chaos_record``; chip_smoke.py keeps its own
copy (port types only), held to this one by the tests.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_sidecar_pins.py``,
it prints the JAX package's record in the form chip_smoke.py pins it.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_scheduler_pins import committed_store_digest  # noqa: E402

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"

#: bench.py's chaos shape (BENCH_CHAOS_CQS / _QUOTA / _WL defaults)
CHAOS_CQS = 8
CHAOS_QUOTA = 32
CHAOS_WORKLOADS = 1024
CHAOS_SEED = 42
#: the churn rounds after the storm, and the holders each one finishes
CHAOS_CHURN = 6
CHAOS_FINISH = 16


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def chaos_store(root: str, n_cqs: int = CHAOS_CQS,
                quota: int = CHAOS_QUOTA, n_wl: int = CHAOS_WORKLOADS):
    """bench.py's chaos store (bench.py:637-656)."""
    T = mod(root, "api.types")
    store = mod(root, "core.store").Store()
    store.upsert_resource_flavor(T.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(T.ClusterQueue(
            name=f"cq{i}", resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f", resources=[
                    T.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(T.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    for i in range(n_wl):
        store.add_workload(T.Workload(
            name=f"w{i}", queue_name=f"lq{i % n_cqs}", uid=i + 1,
            creation_time=float(i),
            podsets=[T.PodSet(name="main", count=1,
                              requests={"cpu": 1})]))
    return store


def chaos_injector(root: str):
    """bench.py's injector (bench.py:660-664)."""
    C = mod(root, "chaos")
    return C.FaultInjector(
        schedule=[C.CRASH, C.GARBLE, C.CORRUPT_PLAN],
        weights={C.CRASH: 2, C.GARBLE: 1, C.TRUNCATE: 1,
                 C.CORRUPT_PLAN: 1, C.OK: 3},
        seed=CHAOS_SEED)


def chaos_record(root: str, device: str = "cpu", **store_kw) -> dict:
    """Run the chaos scenario on ``root``'s package; its record."""
    C = mod(root, "chaos")
    service = mod(root, "solver.service")
    store = chaos_store(root, **store_kw)
    queues = mod(root, "core.queue_manager").QueueManager(store)
    path = os.path.join(tempfile.mkdtemp(), "solver.sock")
    injector = chaos_injector(root)
    if root == JAX:
        srv = C.ChaosSolverServer(path, injector)
        srv.mesh = None  # one device, as the port's sidecar
    else:
        srv = C.ChaosSolverServer(path, injector, device=device)
    srv.serve_in_background()
    Scheduler = mod(root, "scheduler.scheduler").Scheduler
    Engine = mod(root, "solver.engine").SolverEngine
    client = service.SolverClient(path, timeout_s=30.0, max_retries=1,
                                  backoff_base_s=0.01)
    if root == JAX:
        from kueue_oss_tpu import metrics

        rejected0 = metrics.solver_plan_rejected_total.total()
        backend0 = metrics.solver_fallback_total.collect().get(
            ("backend_error",), 0)
        sched = Scheduler(store, queues, solver_min_backlog=64)
        engine = Engine(store, queues, scheduler=sched, remote=client,
                        mesh_mode="off")
    else:
        sched = Scheduler(store, queues, solver_min_backlog=64,
                          device=device)
        engine = Engine(store, queues, device=device, scheduler=sched,
                        remote=client)
    engine.relax_enabled = False
    sched.solver = engine

    def held():
        return sum(1 for w in store.workloads.values()
                   if w.is_quota_reserved and not w.is_finished)

    try:
        cycles = [sched.run_until_quiet(now=0.0, tick=1.0)]
        seats = [held()]
        for r in range(CHAOS_CHURN):
            holders = sorted(k for k, w in store.workloads.items()
                             if w.is_quota_reserved and not w.is_finished)
            for key in holders[:CHAOS_FINISH]:
                sched.finish_workload(key, now=100.0 + r)
            sched._drain_cost_ema = sched._host_s_per_adm = None
            sched._solver_drained_once = False
            cycles.append(sched.run_until_quiet(now=100.0 + r, tick=1.0))
            seats.append(held())
    finally:
        srv.shutdown()
        srv.server_close()
    if root == JAX:
        rejected = int(metrics.solver_plan_rejected_total.total()
                       - rejected0)
        backend = int(metrics.solver_fallback_total.collect().get(
            ("backend_error",), 0) - backend0)
    else:
        rejected = engine.remote_counts["solver_plan_rejected_total"]
        backend = engine.remote_counts["solver_fallback_total"][
            "backend_error"]
    return {"held": seats, "cycles": cycles,
            "faults_by_kind": dict(sorted(injector.injected.items())),
            "faults_injected": injector.faults_injected(),
            "plans_rejected": rejected,
            "backend_errors": backend,
            "frames": dict(sorted(client.frames_by_kind.items())),
            "digest": committed_store_digest(store)}


def reference_pins() -> dict:
    return {"chaos": chaos_record(JAX)}


if __name__ == "__main__":
    print(json.dumps(reference_pins(), indent=1, sort_keys=True))
