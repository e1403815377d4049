"""The mesh arms' runs for either package, and the JAX package's pins.

Every function takes the package name (``JAX`` or ``PORT``). The JAX
package runs on the conftest's 8 virtual CPU devices (a mesh of the
first ``width`` of them); the port on ``meshutil.set_virtual_devices``
(the caller sets and resets it) and the CPU. A record is plain data
(lists, ints, strings, sha256 digests of arrays), so a pin is the JAX
record written out.

- ``full_record``: ``sharded.solve_backlog_full_sharded`` on a store of
  tests/test_full_kernel_parity.py (classical preemption), of
  tests/test_fair_parity.py (fair sharing) or the uneven widths 3 and 5
  of tests/test_multihost.py:205-222; the digest of all 8 outputs.
- ``lean_record``: ``sharded.solve_backlog_sharded`` on the 64-CQ store
  of tests/test_sharded.py::test_cq_count_far_exceeds_devices.
- ``engine_churn``: tests/test_solver_delta.py:510-587, the mesh engine
  (``mesh_force``, ``pad_to = 64``) under finish-and-submit churn: per
  drain the ordered admitted and evicted keys, the arm and the committed
  store's digest; the session's interleave and the shard imbalance.
- ``interleave_balance``: tests/test_multihost.py:225-290, a churned
  lean session on the mesh with the interleave and with the classic
  smallest-slot policy: each one's imbalance and admitted-key digest.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_mesh_pins.py``,
it prints the JAX records (``PINS``), under the conftest's XLA flags.
chip_smoke.py's phase 25 pins (``MESH_REFERENCE``) are printed by
``python tests/torch_mesh_pins.py chip`` (the JAX engine on a 4-device
mesh: ``chip_storm``, ``chip_tas``).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

if __name__ == "__main__":
    import conftest  # noqa: F401  (the XLA flags, before jax loads)

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def digest(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes, in order."""
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def jax_mesh(width: int):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:width]), ("wl",))


def port_mesh(width: int):
    from kueue_oss_tpu_torch.solver import meshutil

    mesh = meshutil.detect_mesh(str(width), device="cpu")
    if mesh is None:
        raise RuntimeError(f"no port mesh of {width}: set "
                           f"meshutil.set_virtual_devices first")
    return mesh


# ---------------------------------------------------------------------------
# the sharded drains
# ---------------------------------------------------------------------------

#: name -> (store kind, seed, width)
FULL_CASES = {
    "classical_s0_w8": ("classical", 0, 8),
    "classical_s3_w8": ("classical", 3, 8),
    "fair_s0_w8": ("fair", 0, 8),
    "fair_s2_w8": ("fair", 2, 8),
    "uneven_w3": ("classical", 7, 3),
    "uneven_w5": ("classical", 7, 5),
}


def full_problem(kind: str, seed: int):
    """The JAX export of a FULL store (host only, no compile)."""
    if kind == "classical":
        from test_sharded_full import export_from_seed

        return export_from_seed(seed)
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.scheduler.scheduler import Scheduler
    from kueue_oss_tpu.solver.tensors import export_problem
    from test_fair_parity import _mk_wl, build_fs_scenario

    store, phase1, phase2 = build_fs_scenario(seed)
    queues = QueueManager(store)
    sched = Scheduler(store, queues, enable_fair_sharing=True)
    uid = 1
    for spec in phase1:
        store.add_workload(_mk_wl(spec, uid))
        uid += 1
    sched.run_until_quiet(now=50.0, tick=1.0)
    for spec in phase2:
        store.add_workload(_mk_wl(spec, uid))
        uid += 1
    pending, parked = {}, {}
    for name, q in queues.queues.items():
        if q.snapshot_order():
            pending[name] = q.snapshot_order()
        if q.inadmissible:
            parked[name] = list(q.inadmissible.values())
    return export_problem(store, pending, include_admitted=True,
                          parked=parked)


def full_record(root: str, case: str) -> dict:
    kind, seed, width = FULL_CASES[case]
    problem = full_problem(kind, seed)
    g_max = int(problem.cq_ngroups.max())
    kw = dict(g_max=g_max, h_max=8, p_max=32, fs_enabled=kind == "fair")
    if root == JAX:
        from kueue_oss_tpu.solver.sharded import solve_backlog_full_sharded

        out = solve_backlog_full_sharded(problem, jax_mesh(width), **kw)
    else:
        from kueue_oss_tpu_torch.convert import problem_from_arrays
        from kueue_oss_tpu_torch.solver.sharded import (
            solve_backlog_full_sharded,
        )

        out = solve_backlog_full_sharded(problem_from_arrays(problem),
                                         port_mesh(width), **kw)
    import numpy as np

    return {"rows": int(problem.wl_cqid.shape[0]),
            "admitted": int(np.asarray(out[0]).sum()),
            "rounds": int(np.asarray(out[4])), "digest": digest(out)}


def lean_problem():
    """tests/test_sharded.py::test_cq_count_far_exceeds_devices's store
    (64 CQs, 777 workloads), the JAX export."""
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.solver.engine import SolverEngine
    from test_solver_parity import Cohort, build_store, make_cq, submit

    rng = random.Random(7)
    cqs = [make_cq(f"cq{i:02d}", 1000, "co") for i in range(64)]
    store = build_store(cqs, [Cohort(name="co")])
    for w in range(777):
        submit(store, f"w{w}", f"cq{rng.randrange(64):02d}", t=float(w),
               cpu=rng.choice([400, 900]), priority=rng.randint(0, 1))
    engine = SolverEngine(store, QueueManager(store), mesh_mode="off")
    problem, _ = engine.export()
    return problem


def lean_record(root: str, width: int = 8) -> dict:
    problem = lean_problem()
    if root == JAX:
        from kueue_oss_tpu.solver.sharded import solve_backlog_sharded

        out = solve_backlog_sharded(problem, jax_mesh(width))
    else:
        from kueue_oss_tpu_torch.convert import problem_from_arrays
        from kueue_oss_tpu_torch.solver.sharded import solve_backlog_sharded

        out = solve_backlog_sharded(problem_from_arrays(problem),
                                    port_mesh(width))
    import numpy as np

    return {"admitted": int(np.asarray(out[0]).sum()),
            "rounds": int(out[4]), "digest": digest(out)}


# ---------------------------------------------------------------------------
# the engine's mesh arm
# ---------------------------------------------------------------------------


def store(root: str, n_cqs: int = 4, quota: int = 8,
          preemption: bool = True):
    """tests/test_solver_delta.py ``_store`` for either package."""
    T = mod(root, "api.types")
    st = mod(root, "core.store").Store()
    st.upsert_resource_flavor(T.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        st.upsert_cluster_queue(T.ClusterQueue(
            name=f"cq{i}",
            preemption=(T.PreemptionPolicy(
                within_cluster_queue="LowerPriority")
                if preemption else T.PreemptionPolicy()),
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f", resources=[
                    T.ResourceQuota(name="cpu", nominal=quota)])])]))
        st.upsert_local_queue(T.LocalQueue(name=f"lq{i}",
                                           cluster_queue=f"cq{i}"))
    return st


def wl(root: str, i: int, prio: int = 0, cpu: int = 1):
    T = mod(root, "api.types")
    return T.Workload(
        name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1, priority=prio,
        creation_time=float(i),
        podsets=[T.PodSet(name="main", count=1, requests={"cpu": cpu})])


def mesh_engine(root: str, st, width: int = 8, **kw):
    """A scheduler and its engine with the mesh arm forced (JAX: the
    first ``width`` conftest devices; the port: the virtual devices)."""
    qm = mod(root, "core.queue_manager").QueueManager(st)
    Scheduler = mod(root, "scheduler.scheduler").Scheduler
    SolverEngine = mod(root, "solver.engine").SolverEngine
    mode = str(width)
    if root == JAX:
        sched = Scheduler(st, qm)
        engine = SolverEngine(st, qm, scheduler=sched, mesh_mode=mode, **kw)
    else:
        sched = Scheduler(st, qm, device="cpu")
        engine = SolverEngine(st, qm, scheduler=sched, mesh_mode=mode,
                              device="cpu", **kw)
    engine.mesh_min_workloads = 0
    engine.mesh_force = True
    return qm, sched, engine


def engine_churn(root: str, cycles: int = 4, keep=None) -> dict:
    """tests/test_solver_delta.py:510-587's mesh engine under churn
    (``keep``, a list, receives the engine)."""
    from torch_scheduler_pins import committed_store_digest

    st = store(root, quota=6, preemption=True)
    for i in range(24):
        st.add_workload(wl(root, i, prio=i % 3))
    _qm, sched, engine = mesh_engine(root, st)
    engine.pad_to = 64
    drains = []
    uid = 1000
    for cyc in range(cycles):
        admitted = sorted(k for k, w in st.workloads.items()
                          if w.is_quota_reserved and not w.is_finished)
        for k in admitted[:2]:
            sched.finish_workload(k, now=float(cyc))
        for j in range(2):
            st.add_workload(wl(root, uid + j, prio=(cyc + j) % 3))
        uid += 2
        r = engine.drain(now=float(cyc))
        drains.append({"admitted": list(r.admitted_keys),
                       "evicted": list(r.evicted_keys),
                       "rounds": int(r.rounds),
                       "arm": engine.last_drain_arm,
                       "digest": committed_store_digest(st)})
    if keep is not None:
        keep.append(engine)
    return {"drains": drains, **_session_facts(root, engine, "full")}


def _session_facts(root: str, engine, kind: str) -> dict:
    import numpy as np

    meshutil = mod(root, "solver.meshutil")
    sess = engine._delta_sessions[kind]
    wl_cqid = np.asarray(sess._last[0]["wl_cqid"])
    n_cqs = len(engine.store.cluster_queues)
    return {"interleave": int(sess._interleave),
            "rows": int(wl_cqid.shape[0]),
            "imbalance": meshutil.shard_imbalance(wl_cqid, n_cqs,
                                                  engine._mesh())}


def interleave_balance(root: str, classic: bool) -> dict:
    """tests/test_multihost.py:225-290: 56 workloads on 4 CQs of quota
    4, then 16 cycles finishing the 2 oldest holders and submitting 2."""
    st = store(root, quota=4, preemption=False)
    _qm, sched, engine = mesh_engine(root, st)
    engine.pad_to = 64
    if classic:
        HostDeltaSession = mod(root, "solver.delta").HostDeltaSession
        sess = HostDeltaSession(cache=engine.export_cache)
        sess.set_interleave = lambda n: None
        engine._delta_sessions["lean"] = sess
    uid = 0
    for _ in range(56):
        st.add_workload(wl(root, uid))
        uid += 1
    keys = list(engine.drain(now=0.0).admitted_keys)
    for cyc in range(16):
        admitted = sorted((w.creation_time, k)
                          for k, w in st.workloads.items()
                          if w.is_quota_reserved and not w.is_finished)
        for _, k in admitted[:2]:
            sched.finish_workload(k, now=float(cyc))
        for _ in range(2):
            st.add_workload(wl(root, uid))
            uid += 1
        keys += list(engine.drain(now=float(cyc + 1)).admitted_keys)
    return {"arm": engine.last_drain_arm,
            "keys": hashlib.sha256("\n".join(keys).encode()).hexdigest(),
            "n_admitted": len(keys), **_session_facts(root, engine, "lean")}


def jax_records() -> dict:
    return {
        "full": {case: full_record(JAX, case) for case in FULL_CASES},
        "lean": lean_record(JAX),
        "engine_churn": engine_churn(JAX),
        "interleave": {"interleaved": interleave_balance(JAX, False),
                       "classic": interleave_balance(JAX, True)},
    }


# ---------------------------------------------------------------------------
# chip_smoke.py phase 25: the JAX engine on a 4-device mesh
# ---------------------------------------------------------------------------

#: phase 25's mesh width
CHIP_WIDTH = 4
#: (b)'s depth: phase 12's TAS store at phase 4's 1,500 workloads
CHIP_TAS_WORKLOADS = 1500


def chip_engine(root: str, st, width: int = CHIP_WIDTH, force=True):
    """Phase 25's engine: sessions on, the relaxed arm off, the mesh arm
    forced (``force``) or left to a floor no drain reaches (the same
    pad and interleave, every drain on the single device)."""
    qm = mod(root, "core.queue_manager").QueueManager(st)
    SolverEngine = mod(root, "solver.engine").SolverEngine
    kw = {} if root == JAX else {"device": "cpu"}
    engine = SolverEngine(st, qm, mesh_mode=str(width), **kw)
    engine.relax_enabled = False
    engine.mesh_min_workloads = 0 if force else 1 << 30
    engine.mesh_force = force
    return qm, engine


def chip_storm(root: str) -> list:
    """25 (a): phase 6's two storm waves on the mesh arm."""
    types = mod(root, "api.types")
    from kueue_oss_tpu_torch.scenarios import (
        baseline_preempt_store,
        preempt_plan_digest,
    )

    st, wave1, wave2 = baseline_preempt_store(types,
                                              mod(root, "core.store").Store)
    _qm, engine = chip_engine(root, st)
    out = []
    for now, wave in ((100.0, wave1), (200.0, wave2)):
        for w in wave:
            st.add_workload(w)
        r = engine.drain(now=now)
        out.append({"admitted": r.admitted, "evicted": r.evicted,
                    "rounds": r.rounds, "arm": engine.last_drain_arm,
                    "held": sum(1 for w in st.workloads.values()
                                if w.is_quota_reserved),
                    "digest": preempt_plan_digest(st, r)})
    return out


def chip_tas(root: str) -> dict:
    """25 (b): a lean mesh drain of phase 12's TAS store (1,500)."""
    types = mod(root, "api.types")
    from kueue_oss_tpu_torch.scenarios import plan_digest, tas_drain_store

    st = tas_drain_store(types, mod(root, "core.store").Store,
                         n_workloads=CHIP_TAS_WORKLOADS)
    qm, engine = chip_engine(root, st)
    r = engine.drain(now=0.0)
    return {"admitted": r.admitted, "rounds": r.rounds,
            "arm": engine.last_drain_arm,
            "parked": sum(len(q.inadmissible)
                          for q in qm.queues.values()),
            "digest": plan_digest(st, r.admitted_keys)}


#: the JAX records (``python tests/torch_mesh_pins.py``)
PINS: dict = {
 "engine_churn": {
  "drains": [
   {
    "admitted": [
     "default/w8",
     "default/w11",
     "default/w2",
     "default/w5",
     "default/w17",
     "default/w20",
     "default/w23",
     "default/w14",
     "default/w10",
     "default/w1",
     "default/w4",
     "default/w7",
     "default/w22",
     "default/w13",
     "default/w16",
     "default/w19",
     "default/w3",
     "default/w6",
     "default/w1001",
     "default/w0",
     "default/w15",
     "default/w18",
     "default/w9",
     "default/w12"
    ],
    "arm": "mesh",
    "digest": "4e944794f9d1eb97139723836bd1bbc086ce7bd6200a4a6ac598db1400bda1a4",
    "evicted": [],
    "rounds": 8
   },
   {
    "admitted": [
     "default/w21",
     "default/w1000",
     "default/w1002",
     "default/w1003"
    ],
    "arm": "mesh",
    "digest": "1be61099a3a65144f604ba86a80cef34feda181b0c32f8b36c16809c46adaabc",
    "evicted": [
     "default/w3",
     "default/w6"
    ],
    "rounds": 4
   },
   {
    "admitted": [
     "default/w6",
     "default/w1004"
    ],
    "arm": "mesh",
    "digest": "5b714b1f07ecc1061df7f7a777555dcfd42b59bef9866b1b39972036f6dbb293",
    "evicted": [],
    "rounds": 2
   },
   {
    "admitted": [
     "default/w1005",
     "default/w1006",
     "default/w1007"
    ],
    "arm": "mesh",
    "digest": "2f081db205154a7ff2a031ff38551d7dc7832e1192f24ec088c048470dba78a6",
    "evicted": [
     "default/w15"
    ],
    "rounds": 4
   }
  ],
  "imbalance": 0.6153846153846154,
  "interleave": 8,
  "rows": 72
 },
 "full": {
  "classical_s0_w8": {
   "admitted": 12,
   "digest": "6e9dc9eceeabc4e718331c386f5c92ca4aff056d721d9502929e5f544961d61d",
   "rounds": 7,
   "rows": 17
  },
  "classical_s3_w8": {
   "admitted": 6,
   "digest": "f2bd9f286ff680e34cc6f97b4874b9a4a05f5e1103a585266f8ae37983453489",
   "rounds": 11,
   "rows": 17
  },
  "fair_s0_w8": {
   "admitted": 5,
   "digest": "c22eb8dce1728ae886dacedd26519e497cb2fc35d97f28ddfea7630c0d2ad156",
   "rounds": 8,
   "rows": 12
  },
  "fair_s2_w8": {
   "admitted": 10,
   "digest": "12bf62a55a87548b54b9130c8b180aa32a1a289ed8aac527b3ae8f43168166ce",
   "rounds": 6,
   "rows": 15
  },
  "uneven_w3": {
   "admitted": 4,
   "digest": "3bb69afe13e61d6ea96e087f51a241dbf9c71b72f1566d9b9b3346eeb270ea54",
   "rounds": 2,
   "rows": 8
  },
  "uneven_w5": {
   "admitted": 4,
   "digest": "3bb69afe13e61d6ea96e087f51a241dbf9c71b72f1566d9b9b3346eeb270ea54",
   "rounds": 2,
   "rows": 8
  }
 },
 "interleave": {
  "classic": {
   "arm": "mesh",
   "imbalance": 3.272727272727273,
   "interleave": 1,
   "keys": "aab0ef4edb0ac9c9789ff6116020211cb8c6c9cf56d72cc1ad736b72674bbfe1",
   "n_admitted": 48,
   "rows": 72
  },
  "interleaved": {
   "arm": "mesh",
   "imbalance": 0.36363636363636365,
   "interleave": 8,
   "keys": "5cc784e2842a12ebb7f3a967547494526cd6ccf38303b7dab6a5494a73125c6b",
   "n_admitted": 48,
   "rows": 72
  }
 },
 "lean": {
  "admitted": 112,
  "digest": "55a1db6abdb4b108ad7f9141886cc89fd4722c7d2834cf24e76a5e800ef85a2c",
  "rounds": 19
 }
}


if __name__ == "__main__":
    if sys.argv[1:] == ["chip"]:
        print(json.dumps({"storm": chip_storm(JAX), "tas": chip_tas(JAX)},
                         indent=1, sort_keys=True))
    else:
        print(json.dumps(jax_records(), indent=1, sort_keys=True))
