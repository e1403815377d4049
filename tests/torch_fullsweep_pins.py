"""The FULL what-if sweeps of chip_smoke.py's phase 19, for either
package.

Phase 19 drives the scenario-batched preemption drain: bench.py's
``fullsweep`` shape (a Philly trace with its earliest 40% admitted, 64
quota x arrival worlds, bench.py:1552-1603) in one dispatch and at a
chunk width of 8 (a), the tiered sweep on that problem (b), and
``WhatIfEngine(resident=True).run(full=True)`` on the baseline backlog
through its full, scatter and reuse syncs (c). The stores built here
serve both packages (``root`` is the package name), so
tests/test_torch_fullsweep.py and the pins below run the same worlds.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_fullsweep_pins.py``,
it prints the JAX package's records in the form chip_smoke.py pins
them (under tests/conftest.py's XLA flags, as the relax tier's pins).
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_relax_pins import CONFTEST_XLA_FLAGS  # noqa: E402

if __name__ == "__main__":
    # before anything loads JAX: the relax tier's x is the JAX program's
    # under tier-1's flags
    os.environ["XLA_FLAGS"] = CONFTEST_XLA_FLAGS
    os.environ["JAX_PLATFORMS"] = "cpu"

from torch_sim_pins import (  # noqa: E402
    WHATIF_QUOTA,
    baseline_config,
    plan_digest,
)

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"

#: bench.py's fullsweep grid (bench.py:1591-1593), cycled to S = 64
FULLSWEEP_QUOTA = (0.25, 0.4, 0.5, 0.75, 1.5, 2.0)
FULLSWEEP_ARRIVAL = (0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0)
FULLSWEEP_S = 64
#: phase 19 (a)'s trace length (bench.py takes 7 by default and scales W
#: on real hardware) and its forced chunk width
FULLSWEEP_JOBS = 256
FULLSWEEP_CHUNK = 8
#: phase 19 (c) on the baseline backlog at its full depth: the share of
#: the pending workloads removed between runs 1 and 2 (75 of 15,000),
#: and the worlds of every run, the first of the quota x arrival grid
#: with ``ENGINE_ARRIVAL`` (once phase 17 (b)'s grid): the base
#: quota at arrival 1, 0.25, 0.5 and 0.75 (worlds with another quota
#: ping-pong towards the 2 W1 + C + 5 round bound at this depth)
ENGINE_REMOVED = 0.005
ENGINE_WORLDS = 4
ENGINE_ARRIVAL = (0.25, 0.5, 0.75)


def engine_specs(root: str):
    """Phase 19 (c)'s worlds."""
    sim = _mod(root, "sim")
    return sim.cross(sim.quota_sweep(WHATIF_QUOTA),
                     sim.arrival_sweep(ENGINE_ARRIVAL))[:ENGINE_WORLDS]


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def admit(root: str, store, wl, cq: str, flavors: dict,
          now: float) -> None:
    """Admit ``wl`` into ``cq``, each podset's requests under ``flavors``
    (resource -> flavor), as bench.py's fullsweep and
    tests/test_fullsweep.py admit their incumbents."""
    types = _mod(root, "api.types")
    wl.status.admission = types.Admission(
        cluster_queue=cq,
        podset_assignments=[types.PodSetAssignment(
            name=ps.name,
            flavors={r: f for r, f in flavors.items() if r in ps.requests},
            resource_usage={r: q * ps.count
                            for r, q in ps.requests.items()},
            count=1) for ps in wl.podsets])
    wl.set_condition(types.WorkloadConditionType.QUOTA_RESERVED, True,
                     reason="QuotaReserved", now=now)
    store.update_workload(wl)


def add_numbered(store, schedule) -> None:
    """Add a generated schedule's workloads with uids 1, 2, ... in
    schedule order: the generators draw uids from a counter of the
    process, which earlier stores advance, and the uid breaks ties."""
    for i, g in enumerate(schedule):
        g.workload.uid = i + 1
        store.add_workload(g.workload)


def trace_store(root: str, n_jobs: int, seed: int = 11,
                capacity_frac: float = 0.25, admitted: float = 0.4):
    """bench.py's fullsweep store: ``philly_trace(n_jobs, seed)`` as a
    contended store, its earliest ``admitted`` share holding quota."""
    traces = _mod(root, "sim.traces")
    jobs = traces.philly_trace(n_jobs, seed=seed)
    store = traces.store_from_trace(jobs, capacity_frac=capacity_frac)
    for j in sorted(jobs, key=lambda j: j.submit_s)[
            : int(n_jobs * admitted)]:
        admit(root, store, store.workloads[f"default/{j.job_id}"], j.vc,
              {"gpu": "gpu"}, j.submit_s)
    return store


def contended_store(root: str, counts=(5, 2, 1)):
    """tests/test_fullsweep.py's store: large_scale(preemption=True) cut
    to 2 x 2 ClusterQueues, every workload loaded, every third (by key)
    admitted so quota cuts have victims."""
    gen = _mod(root, "perf.generator")
    cfg = gen.GeneratorConfig.large_scale(preemption=True)
    cfg.n_cohorts, cfg.cqs_per_cohort = 2, 2
    for wc, n in zip(cfg.classes, counts):
        wc.count = n
    store, schedule = gen.generate(cfg)
    add_numbered(store, schedule)
    for i, wl in enumerate(sorted(store.workloads.values(),
                                  key=lambda w: w.key)):
        if i % 3:
            continue
        cq = store.local_queues[f"{wl.namespace}/{wl.queue_name}"]
        admit(root, store, wl, cq.cluster_queue, {"cpu": "default"},
              10.0 + i)
    return store


def sweep_problem(root: str, store, pending=None, afs=None,
                  now: float = 0.0):
    """The padded FULL export of ``store`` (admitted rows included), as
    the sweeps take it. Returns (problem, real workload count)."""
    tensors = _mod(root, "solver.tensors")
    sim = _mod(root, "sim")
    if pending is None:
        pending = sim.pending_backlog(store)
    problem = tensors.export_problem(
        store, pending, cache=tensors.ExportCache(store, subscribe=False),
        include_admitted=True, afs=afs, now=now)
    W = problem.n_workloads
    return tensors.pad_workloads(problem, tensors.pow2(W)), W


def hetero_store(root: str, scale: float = 0.35):
    """``scenarios.heterogeneous_preempt_store`` (two resource groups:
    two fungible cpu + memory flavors and an accelerator group) with
    both waves loaded and every third workload of wave 1 admitted on
    on-demand + accel."""
    types = _mod(root, "api.types")
    store_mod = _mod(root, "core.store")
    scenarios = importlib.import_module("kueue_oss_tpu_torch.scenarios")
    store, wave1, wave2 = scenarios.heterogeneous_preempt_store(
        types, store_mod.Store, n_cohorts=1, cqs_per_cohort=3,
        scale=scale)
    for wl in wave1 + wave2:
        store.add_workload(wl)
    for i, wl in enumerate(wave1):
        if i % 3 == 0:
            cq = store.local_queues[f"{wl.namespace}/{wl.queue_name}"]
            admit(root, store, store.workloads[wl.key], cq.cluster_queue,
                  {"cpu": "on-demand", "memory": "on-demand",
                   "gpu": "accel"}, float(i))
    return store


def afs_store(root: str, scale: float = 0.05):
    """``scenarios.afs_baseline_store`` (every ClusterQueue under
    admission fair sharing, two LocalQueues each, the ``-a`` ones
    pre-charged) with the backlog loaded and every third workload
    admitted. Returns (store, afs manager)."""
    types = _mod(root, "api.types")
    store_mod = _mod(root, "core.store")
    afs_mod = _mod(root, "core.afs")
    scenarios = importlib.import_module("kueue_oss_tpu_torch.scenarios")
    store, afs, backlog = scenarios.afs_baseline_store(
        types, store_mod.Store, afs_mod.AfsManager, n_cohorts=1,
        cqs_per_cohort=3, scale=scale)
    for wl in backlog:
        store.add_workload(wl)
    for i, wl in enumerate(backlog):
        if i % 3 == 0:
            cq = store.local_queues[f"{wl.namespace}/{wl.queue_name}"]
            admit(root, store, store.workloads[wl.key], cq.cluster_queue,
                  {"cpu": "default"}, float(i))
    return store, afs


def fullsweep_specs(root: str, n: int = FULLSWEEP_S):
    sim = _mod(root, "sim")
    grid = sim.cross(sim.quota_sweep(FULLSWEEP_QUOTA),
                     sim.arrival_sweep(FULLSWEEP_ARRIVAL))
    return (grid * (n // len(grid) + 1))[:n]


FULL_FIELDS = ("admitted", "opt", "admit_round", "parked", "rounds",
               "usage", "wl_usage", "victim_reason")


def sweep_record(res, n_real: int) -> dict:
    """A FullSweepResult's plan digest (all eight fields, in scenario
    order), tiers, rounds, admissions and preemptions per scenario."""
    return {"plan_digest": plan_digest([getattr(res, f)
                                        for f in FULL_FIELDS]),
            "tier": list(res.tier),
            "rounds": [int(r) for r in res.rounds],
            "admitted": [int(a[:n_real].sum()) for a in res.admitted],
            "preemptions": [res.preemptions(i, n_real)
                            for i in range(len(res.tier))]}


def engine_store(root: str):
    """Kueue's baseline backlog, every workload pending at t0 (phase 17
    (b)'s store)."""
    gen = _mod(root, "perf.generator")
    store, schedule = gen.generate(baseline_config(gen))
    add_numbered(store, schedule)
    return store


def engine_removed(store, share: float = ENGINE_REMOVED) -> list:
    """The keys of the pending workloads removed between runs 1 and 2:
    ``share`` of them (at least one), every (total // n)-th by key, each
    leaving another pending workload of its queue, priority and requests
    behind (its scheduling-equivalence class stays, so the export keeps
    its shapes and the resident session syncs by scatter)."""
    pending = sorted(k for k, w in store.workloads.items()
                     if w.status.admission is None)
    n = max(1, round(len(pending) * share))

    def kind(w):
        return (w.queue_name, w.priority,
                tuple((ps.count, tuple(sorted(ps.requests.items())))
                      for ps in w.podsets))

    left = collections.Counter(kind(store.workloads[k]) for k in pending)
    out = []
    for k in pending[::max(1, len(pending) // n)] + pending:
        c = kind(store.workloads[k])
        if len(out) < n and k not in out and left[c] > 1:
            left[c] -= 1
            out.append(k)
    return out


def engine_record(report) -> dict:
    """A FULL WhatIfReport's canonical digest, rounds, admissions,
    preemptions and tiers per scenario, and its parity."""
    import hashlib

    return {"canonical_sha256": hashlib.sha256(
                report.canonical_json().encode()).hexdigest(),
            "rounds": [s["rounds"] for s in report.scenarios],
            "admitted": [s["admitted"] for s in report.scenarios],
            "preemptions": [s["preemptions"] for s in report.scenarios],
            "tier": [s["tier"] for s in report.scenarios],
            "parity": report.parity}


def engine_runs(root: str, store, specs):
    """Phase 19 (c): run 1 over ``specs`` (parity on 2), then
    ``engine_removed`` deleted and run 2 over them, then run 3 with
    nothing changed (the port on the CPU). Returns (engine, [report1,
    report2, report3], [sync kinds])."""
    sim = _mod(root, "sim")
    config = _mod(root, "config.configuration").SimulatorConfig(
        full_kernel=True)
    kw = {} if root == JAX else {"device": "cpu"}
    engine = sim.WhatIfEngine(store, config=config, resident=True, **kw)
    reports, syncs = [], []

    def run(par):
        before = dict(engine.resident.stats())
        reports.append(engine.run(specs, parity=par))
        after = engine.resident.stats()
        syncs.append(next(
            kind for kind, key in (("full", "full_uploads"),
                                   ("scatter", "scatter_refreshes"),
                                   ("reuse", "reuses"))
            if after[key] > before[key]))

    run(2)
    for key in engine_removed(store):
        store.delete_workload(key)
    run(0)
    run(0)
    return engine, reports, syncs


def reference_pins() -> dict:
    """The JAX package's records of phase 19."""
    import time

    B = _mod(JAX, "sim.batch")
    fk = _mod(JAX, "solver.full_kernels")
    out = {}
    t0 = time.monotonic()
    problem, W = sweep_problem(JAX, trace_store(JAX, FULLSWEEP_JOBS))
    specs = fullsweep_specs(JAX)
    overlays = [s.overlay(problem) for s in specs]
    caps = B.full_caps(problem)
    tensors = fk.to_device_full(problem)
    order = B.sweep_order(specs)
    out["fullsweep"] = sweep_record(B.solve_scenarios_full(
        problem, overlays, *caps, tensors=tensors, order=order), W)
    tiered = B.solve_scenarios_tiered(
        problem, overlays, budget=B.LaneBudget(max_full_scenarios=32),
        caps=caps, tensors=tensors, order=order)
    out["tiered"] = {"retier_idx": list(tiered.retier_idx),
                     "retier_reason": tiered.retier_reason,
                     **sweep_record(tiered, W)}
    out["all_relax"] = sweep_record(B.solve_scenarios_tiered(
        problem, overlays, budget=B.LaneBudget(budget_bytes=1), caps=caps,
        tensors=tensors, order=order), W)
    print(f"# fullsweep {time.monotonic() - t0:.1f} s", file=sys.stderr)
    t0 = time.monotonic()
    _, reports, syncs = engine_runs(JAX, engine_store(JAX),
                                    engine_specs(JAX))
    out["engine"] = {"syncs": syncs,
                     "runs": [engine_record(r) for r in reports]}
    print(f"# engine {time.monotonic() - t0:.1f} s", file=sys.stderr)
    return out


def main() -> None:
    print(json.dumps(reference_pins(), indent=1))


if __name__ == "__main__":
    main()
