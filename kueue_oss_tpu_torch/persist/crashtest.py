"""Crash-point chaos harness: kill -9 the control plane, then prove
recovery is byte-identical to never having crashed.

A copy of ``kueue_oss_tpu/persist/crashtest.py``. Run as a subprocess
(``python -m kueue_oss_tpu_torch.persist.crashtest``); ``--device``
(``cuda`` unless the caller asks for ``cpu``) is where the scheduler and
the ``--solver`` drains run, and ``cuda`` raises without a CUDA device:

  --phase run      build the deterministic scenario from scratch with
                   persistence attached and play it to completion,
                   writing <dir>/final.dump (the canonical store
                   bytes). With KUEUE_CRASH_POINT armed in the
                   environment the process SIGKILLs itself at the named
                   point instead of finishing — that IS the test run.
  --phase recover  recover the store from <dir> (newest valid
                   checkpoint + WAL suffix), then REPLAY the same
                   scenario script on top. Every step is idempotent
                   (ensure-object guards, finish-if-not-finished), so
                   from any crash point the rerun converges to the
                   no-crash end state; the phase writes
                   <dir>/final.dump and prints a JSON status line.

The equality contract: a baseline ``run`` (no crash) and a
``run``-crashed-then-``recover`` sequence must produce byte-identical
final.dump files. Determinism is engineered, not hoped for: every
virtual timestamp is a fixed phase constant (tick=0 cycles), workload
uids are assigned explicitly, and the scheduler/solver paths are the
deterministic production code the rebuild tests already pin down.

``--solver`` routes the T2/T3 admission floods through SolverEngine
drains (sessions enabled), which makes two more assertions available
to the recover phase: the first post-restart drain's session frame is
a full SYNC (resident device state is gone by design), and the
invariant auditor reports zero violations over the recovered store.
Its status line also counts the drains each solver arm served
(``drains_by_arm``) and the local solve faults the engine turned into
host cycles (``device_error``, ``solver_fallback_total{device_error}``),
so a caller can tell drains that ran on the device from rounds that
``settle`` finished on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kueue_oss_tpu_torch.persist import hooks

T1, T2, T3, T4 = 20.0, 30.0, 40.0, 50.0


def _mk_wl(name: str, uid: int, lq: str, cpu_m: int, prio: int,
           created: float):
    from kueue_oss_tpu_torch.api.types import PodSet, Workload

    return Workload(
        name=name, namespace="default", queue_name=lq, priority=prio,
        uid=uid, creation_time=created,
        podsets=[PodSet(name="main", count=1, requests={"cpu": cpu_m})])


def ensure_objects(store) -> None:
    """Cluster topology; guarded so a recovery rerun emits no events
    (re-upserting identical specs would still bump cq_generation)."""
    from kueue_oss_tpu_torch.api.types import (
        ClusterQueue,
        Cohort,
        FlavorQuotas,
        LocalQueue,
        PreemptionPolicy,
        PreemptionPolicyValue,
        ResourceFlavor,
        ResourceGroup,
        ResourceQuota,
    )

    if "default" not in store.resource_flavors:
        store.upsert_resource_flavor(ResourceFlavor(name="default"))
    if "pool" not in store.cohorts:
        store.upsert_cohort(Cohort(name="pool"))
    for cq_name in ("cq-a", "cq-b"):
        if cq_name in store.cluster_queues:
            continue
        store.upsert_cluster_queue(ClusterQueue(
            name=cq_name, cohort="pool",
            resource_groups=[ResourceGroup(
                covered_resources=["cpu"],
                flavors=[FlavorQuotas(name="default", resources=[
                    ResourceQuota(name="cpu", nominal=8000)])])],
            preemption=PreemptionPolicy(
                within_cluster_queue=(
                    PreemptionPolicyValue.LOWER_PRIORITY)),
        ))
    for lq_name, cq_name in (("lq-a", "cq-a"), ("lq-b", "cq-b")):
        if f"default/{lq_name}" not in store.local_queues:
            store.upsert_local_queue(
                LocalQueue(name=lq_name, cluster_queue=cq_name))


#: (name, uid, local queue, cpu millicores, priority, arrival phase)
BATCH_A = [(f"a{i}", 10 + i, "lq-a", 2000, 0, T1) for i in range(4)] + \
          [(f"b{i}", 20 + i, "lq-b", 2000, 0, T1) for i in range(4)]
BATCH_B = [("high0", 30, "lq-a", 4000, 100, T2),
           ("high1", 31, "lq-a", 4000, 100, T2),
           ("b4", 32, "lq-b", 2000, 0, T2),
           ("b5", 33, "lq-b", 2000, 0, T2)]


def ensure_batch(store, batch) -> int:
    added = 0
    for name, uid, lq, cpu_m, prio, created in batch:
        if f"default/{name}" not in store.workloads:
            store.add_workload(_mk_wl(name, uid, lq, cpu_m, prio,
                                      created))
            added += 1
    return added


def settle(sched, engine, now: float, arms: dict | None = None) -> None:
    """One drain (with a solver) and host cycles to quiescence; ``arms``
    counts the drains by the arm that served them."""
    if engine is not None:
        from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable
        from kueue_oss_tpu_torch.solver.tensors import UnsupportedProblem

        engine.last_drain_arm = None
        try:
            engine.drain(now=now)
        except (SolverUnavailable, UnsupportedProblem):
            pass  # host cycles mop up below, same as production
        else:
            if arms is not None and engine.last_drain_arm is not None:
                arms[engine.last_drain_arm] = (
                    arms.get(engine.last_drain_arm, 0) + 1)
    sched.run_until_quiet(now=now, max_cycles=300, tick=0.0)


#: jobs that complete at T3 — a FIXED list, because job completion is
#: an external event (the job controller's), not a function of store
#: state: deriving the set from the live state would make a recovery
#: rerun pick differently once durable progress moved past T3
FINISH_AT_T3 = ["default/b0", "default/b1", "default/b2"]


def finish_jobs(store, sched, keys, now: float) -> list[str]:
    done = []
    for key in keys:
        wl = store.workloads.get(key)
        if wl is not None and not wl.is_finished:
            sched.finish_workload(key, now=now)
            done.append(key)
    return done


def play(store, sched, engine, manager, arms: dict | None = None) -> None:
    """The scenario script — every step idempotent, timestamps fixed."""
    ensure_objects(store)
    ensure_batch(store, BATCH_A)
    settle(sched, engine, T1, arms)
    manager.checkpoint()  # mid-scenario checkpoint: recovery spans both
    ensure_batch(store, BATCH_B)
    settle(sched, engine, T2, arms)
    finish_jobs(store, sched, FINISH_AT_T3, T3)
    settle(sched, engine, T3, arms)
    settle(sched, engine, T4, arms)
    manager.flush()


def _build_control_plane(store, solver: bool, device):
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    queues = QueueManager(store)
    sched = Scheduler(store, queues, device=device)
    engine = None
    if solver:
        from kueue_oss_tpu_torch.solver.engine import SolverEngine

        engine = SolverEngine(store, queues, scheduler=sched,
                              device=device)
    return sched, engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--phase", choices=("run", "recover"),
                    required=True)
    ap.add_argument("--solver", action="store_true",
                    help="route admission floods through SolverEngine "
                         "drains (sessions on)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from kueue_oss_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.persist import (
        InvariantAuditor,
        PersistenceManager,
        canonical_dump,
    )

    status: dict = {"phase": args.phase, "solver": args.solver,
                    "device": str(device)}
    if args.phase == "run":
        hooks.arm_from_env()
        manager = PersistenceManager(args.dir, fsync="always",
                                     checkpoint_interval_seconds=0.0)
        store = Store()
        manager.attach(store)
        sched, engine = _build_control_plane(store, args.solver, device)
    else:
        manager = PersistenceManager(args.dir, fsync="always",
                                     checkpoint_interval_seconds=0.0)
        rr = manager.recover()
        store = rr.store
        manager.attach(store)
        sched, engine = _build_control_plane(store, args.solver, device)
        status.update(rr.to_dict())
        if engine is not None:
            # resident device/sidecar session state is gone by design;
            # the first post-restart drain must open with a full SYNC
            engine.reset_sessions(reason="restart")

    arms: dict = {}
    play(store, sched, engine, manager, arms)

    if engine is not None:
        from kueue_oss_tpu_torch import metrics

        status["drains_by_arm"] = arms
        status["device_error"] = int(
            metrics.solver_fallback_total.value("device_error"))
        sess = engine._delta_sessions.get("lean") or \
            engine._delta_sessions.get("full")
        status["session_full_syncs"] = (
            sess.full_syncs if sess is not None else 0)
        status["session_first_frame_sync"] = (
            sess is not None and sess.full_syncs >= 1)
    violations = InvariantAuditor(store).audit()
    status["audit_violations"] = [v.to_dict() for v in violations]

    dump = canonical_dump(store)
    out = os.path.join(args.dir, "final.dump")
    with open(out, "wb") as f:
        f.write(dump)
    status["dump"] = out
    status["dump_bytes"] = len(dump)
    status["completed"] = True
    print(json.dumps(status), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
