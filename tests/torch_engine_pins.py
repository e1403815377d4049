"""The JAX package's sessions-on plans of chip_smoke.py's phases 6-9.

Phases 6-9 drive the port's engine with delta sessions on (its
default), so their pins are the JAX engine's plans with sessions on and
without a mesh (``mesh_mode="off"``), on the same full-size stores:

- phase 6, the baseline storm's two waves: the first two drains of
  phase 10's sequence (``STORM_CHURN_REFERENCE[:2]`` in chip_smoke.py,
  printed by ``tests/test_torch_engine_sessions.py``);
- phase 7, the TAS store with preemption at 1,500 workloads;
- phases 8 and 9, the fair reclamation storm and the AFS backlog.

Run ``JAX_PLATFORMS=cpu python tests/torch_engine_pins.py`` to print
them (a few minutes on one CPU core: the FULL drains at full size).
The tests hold the port to the JAX engine with sessions on at a small
size (tests/test_torch_engine_full.py, tests/test_torch_engine_fair.py).
"""

from __future__ import annotations

import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _engine(store, afs=None, fs=False):
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.scheduler.scheduler import Scheduler
    from kueue_oss_tpu.solver.engine import SolverEngine

    queues = QueueManager(store, afs=afs)
    engine = SolverEngine(store, queues,
                          scheduler=Scheduler(store, queues),
                          enable_fair_sharing=fs, mesh_mode="off")
    engine.use_sessions = True
    engine.relax_enabled = False
    return queues, engine


def _held(store) -> int:
    return sum(1 for w in store.workloads.values() if w.is_quota_reserved)


def tas_full_pin() -> dict:
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu_torch.scenarios import plan_digest, tas_drain_store

    store = tas_drain_store(types, Store, n_workloads=1500, preempt=True)
    queues, engine = _engine(store)
    result = engine.drain(now=0.0)
    return {"admitted": result.admitted, "evicted": result.evicted,
            "rounds": result.rounds,
            "parked": sum(len(q.inadmissible)
                          for q in queues.queues.values()),
            "digest": plan_digest(store, result.admitted_keys)}


def fair_pins() -> list:
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        fair_reclaim_store,
        preempt_plan_digest,
    )

    store, wave1, wave2 = fair_reclaim_store(types, Store)
    _, engine = _engine(store, fs=True)
    out = []
    for now, wave in ((100.0, wave1), (200.0, wave2)):
        for wl in wave:
            store.add_workload(wl)
        result = engine.drain(now=now)
        out.append({"admitted": result.admitted, "evicted": result.evicted,
                    "rounds": result.rounds, "held": _held(store),
                    "digest": preempt_plan_digest(store, result)})
    return out


def afs_pin() -> dict:
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.afs import AfsManager
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        afs_baseline_store,
        preempt_plan_digest,
    )

    store, afs, backlog = afs_baseline_store(types, Store, AfsManager)
    _, engine = _engine(store, afs=afs)
    for wl in backlog:
        store.add_workload(wl)
    result = engine.drain(now=60.0)
    return {"admitted": result.admitted, "evicted": result.evicted,
            "rounds": result.rounds, "held": _held(store),
            "digest": preempt_plan_digest(store, result),
            "sides": dict(sorted(collections.Counter(
                store.workloads[k].queue_name[-1]
                for k in result.admitted_keys).items()))}


if __name__ == "__main__":
    out = {}
    for name, fn in (("tas_full", tas_full_pin), ("fair", fair_pins),
                     ("afs", afs_pin)):
        out[name] = fn()
        print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    print(json.dumps(out, indent=1))
