"""The scheduler runs of chip_smoke.py's phases 11-14, for either package.

Phase 11 drives the baseline preemption storm through
``Scheduler(solver="auto")`` wave by wave, with a host-only twin
(``solver=None``); phase 12 the TAS drain store; phase 13 the storm
with memory in bytes, which every drain refuses at export; phase 14
the mixed TAS store (``run_tas_mixed``) in four runs: with and without
the device drain, each with TASDeviceFillCounts off and on. Each run
records, per wave: the committed-store digest, the workloads holding
quota, the evicted ones and their Preempted reasons, the host cycles
``run_until_quiet`` took, the device drains and the drains that raised
``UnsupportedProblem``.

The JAX side is the JAX ``Scheduler`` over a JAX ``SolverEngine`` built
with ``mesh_mode="off"`` and ``scheduler=`` that scheduler, passed in as
the engine instance; the port side is the port's
``Scheduler(solver="auto", device=...)``. chip_smoke.py keeps its own
copy of ``committed_store_digest`` (port types only); the tests hold the
two copies to each other.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_scheduler_pins.py``,
it prints the JAX package's records at full size in the form
chip_smoke.py pins them (a few minutes: the TAS drain dominates).
"""

from __future__ import annotations

import collections
import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kueue_oss_tpu_torch import scenarios  # noqa: E402


def committed_store_digest(store) -> str:
    """sha256 over the sorted workload keys of each workload's
    QuotaReserved and Admitted status, its admission (ClusterQueue, and
    per podset the flavors, count, resource usage and topology
    assignment), its Evicted and Preempted conditions (status, reason)
    and its requeue state; works on either package's store."""
    rows = []
    for key in sorted(store.workloads):
        wl = store.workloads[key]
        adm = wl.status.admission
        row = [key, wl.is_quota_reserved, wl.is_admitted]
        if adm is None:
            row.append(None)
        else:
            podsets = []
            for psa in adm.podset_assignments:
                ta = psa.topology_assignment
                podsets.append([
                    psa.name, sorted(psa.flavors.items()), psa.count,
                    sorted(psa.resource_usage.items()),
                    None if ta is None else
                    [list(ta.levels),
                     [[list(d.values), d.count] for d in ta.domains]]])
            row.append([adm.cluster_queue, podsets])
        for ctype in ("Evicted", "Preempted"):
            c = wl.status.conditions.get(ctype)
            row.append(None if c is None else [c.status, c.reason])
        rs = wl.status.requeue_state
        row.append(None if rs is None else [rs.count, rs.requeue_at])
        rows.append(row)
    return hashlib.sha256(json.dumps(
        rows, separators=(",", ":")).encode()).hexdigest()


def store_counts(store) -> dict:
    """Workloads holding quota, evicted ones, and the evicted ones'
    Preempted reasons."""
    evicted = [w for w in store.workloads.values() if w.is_evicted]
    return {"held": sum(1 for w in store.workloads.values()
                        if w.is_quota_reserved),
            "evicted": len(evicted),
            "reasons": dict(sorted(collections.Counter(
                w.status.conditions["Preempted"].reason
                for w in evicted
                if "Preempted" in w.status.conditions).items()))}


class CountedDrains:
    """Wraps an engine's ``drain`` to count the calls, the ones that
    raised ``UnsupportedProblem`` and the admissions committed."""

    def __init__(self, engine, unsupported_exc) -> None:
        self.engine = engine
        self._drain = engine.drain
        self._exc = unsupported_exc
        self.calls = self.unsupported = self.admitted = 0
        engine.drain = self

    def __call__(self, *args, **kwargs):
        self.calls += 1
        try:
            result = self._drain(*args, **kwargs)
        except self._exc:
            self.unsupported += 1
            raise
        self.admitted += result.admitted
        return result

    def take(self) -> dict:
        out = {"drains": self.calls - self.unsupported,
               "unsupported": self.unsupported,
               "drain_admitted": self.admitted}
        self.calls = self.unsupported = self.admitted = 0
        return out


def jax_package():
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu.scheduler.scheduler import Scheduler
    from kueue_oss_tpu.solver.engine import SolverEngine
    from kueue_oss_tpu.solver.tensors import UnsupportedProblem

    def make(store, solver: bool, afs=None, **kw):
        queues = QueueManager(store, afs=afs)
        sched = Scheduler(store, queues, **kw)
        drains = None
        if solver:
            engine = SolverEngine(store, queues, scheduler=sched,
                                  enable_fair_sharing=kw.get(
                                      "enable_fair_sharing", False),
                                  mesh_mode="off")
            # the relaxed arm routes by wall clock: pinned off
            engine.relax_enabled = False
            sched.solver = engine
            drains = CountedDrains(engine, UnsupportedProblem)
        return sched, drains

    from kueue_oss_tpu.core.afs import AfsManager

    return types, Store, make, AfsManager


def port_package(device: str = "cpu"):
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.tensors import UnsupportedProblem

    def make(store, solver: bool, afs=None, **kw):
        sched = Scheduler(store, QueueManager(store, afs=afs),
                          solver="auto" if solver else None,
                          device=device, **kw)
        drains = None
        if solver:
            engine = sched._solver_engine()
            engine.relax_enabled = False
            drains = CountedDrains(engine, UnsupportedProblem)
        return sched, drains

    from kueue_oss_tpu_torch.core.afs import AfsManager

    return types, Store, make, AfsManager


def _record(store, sched, drains, cycles: int) -> dict:
    out = {"cycles": cycles, **store_counts(store),
           "digest": committed_store_digest(store)}
    if drains is not None:
        out.update(drains.take())
    return out


def run_waves(package, builder, *, solver: bool, times=(100.0, 200.0),
              tick: float = 0.001, sched_kw=None, after=None,
              **kwargs) -> list:
    """Add each wave of ``builder(types, Store, **kwargs)`` and run
    ``run_until_quiet(now=t, tick=tick)``; one record per wave.
    ``sched_kw`` goes to the Scheduler; ``after(store, sched)``, if
    given, runs once more after the last wave (for example finishes)
    and its own ``run_until_quiet`` makes a last record."""
    types, store_cls, make, _ = package
    store, *waves = builder(types, store_cls, **kwargs)
    sched, drains = make(store, solver, **(sched_kw or {}))
    out = []
    for wave, now in zip(waves, times):
        for wl in wave:
            store.add_workload(wl)
        cycles = sched.run_until_quiet(now=now, tick=tick)
        out.append(_record(store, sched, drains, cycles))
    if after is not None:
        now = after(store, sched)
        cycles = sched.run_until_quiet(now=now, tick=tick)
        out.append(_record(store, sched, drains, cycles))
    return out


def run_afs(package, *, sched_kw=None, **kwargs) -> dict:
    """The admission-fair-sharing backlog (``afs_baseline_store``)
    through one ``run_until_quiet(now=60.0, tick=0.001)``."""
    types, store_cls, make, afs_cls = package
    store, afs, backlog = scenarios.afs_baseline_store(
        types, store_cls, afs_cls, **kwargs)
    sched, drains = make(store, True, afs=afs, **(sched_kw or {}))
    for wl in backlog:
        store.add_workload(wl)
    cycles = sched.run_until_quiet(now=60.0, tick=0.001)
    return _record(store, sched, drains, cycles)


def run_tas(package, *, solver: bool = True, **kwargs) -> dict:
    """The TAS drain store (all its workloads pending from the start)
    through one ``run_until_quiet(now=0.0, tick=0.001)``."""
    types, store_cls, make, _ = package
    store = scenarios.tas_drain_store(types, store_cls, **kwargs)
    sched, drains = make(store, solver)
    cycles = sched.run_until_quiet(now=0.0, tick=0.001)
    rec = _record(store, sched, drains, cycles)
    rec["parked"] = sum(len(q.inadmissible)
                        for q in sched.queues.queues.values())
    return rec


def _package_module(types, name: str):
    """The module ``name`` of the package that ``types`` belongs to."""
    import importlib

    return importlib.import_module(
        f"{types.__name__.split('.')[0]}.{name}")


def queue_state(queues) -> dict:
    """Each ClusterQueue's heap and parked keys, and the second-pass
    queue (heap and per-key attempts)."""
    return {"queues": {n: (sorted(q._in_heap), sorted(q.inadmissible))
                       for n, q in sorted(queues.queues.items())},
            "second_pass": (sorted(queues._second_pass_heap),
                            sorted(queues._second_pass_iteration.items()))}


def run_tas_mixed(package, *, solver: bool, fill: bool,
                  with_queues: bool = False, **kwargs) -> dict:
    """The mixed TAS store (``tas_mixed_store``) through one
    ``run_until_quiet(now=100.0, tick=0.001)``, with the
    TASDeviceFillCounts gate set to ``fill`` for the run. The record
    adds the parked workloads, the leader groups holding quota and the
    ``_fill_in_counts`` calls of the host placement (and, with
    ``with_queues``, ``queue_state``)."""
    types, store_cls, make, _ = package
    features = _package_module(types, "features")
    snap_cls = _package_module(types, "tas.snapshot").TASFlavorSnapshot
    store = scenarios.tas_mixed_store(types, store_cls, **kwargs)
    sched, drains = make(store, solver)
    calls = [0]
    fill_in_counts = snap_cls._fill_in_counts

    def counted(self, *args, **kw):
        calls[0] += 1
        return fill_in_counts(self, *args, **kw)

    was = features.enabled("TASDeviceFillCounts")
    features.set_gates({"TASDeviceFillCounts": fill})
    snap_cls._fill_in_counts = counted
    try:
        cycles = sched.run_until_quiet(now=100.0, tick=0.001)
    finally:
        snap_cls._fill_in_counts = fill_in_counts
        features.set_gates({"TASDeviceFillCounts": was})
    rec = _record(store, sched, drains, cycles)
    rec["parked"] = sum(len(q.inadmissible)
                        for q in sched.queues.queues.values())
    rec["groups"] = sum(1 for w in store.workloads.values()
                        if w.is_quota_reserved and len(w.podsets) == 2)
    rec["fills"] = calls[0]
    if with_queues:
        rec.update(queue_state(sched.queues))
    return rec


#: phase 14's four runs: (name, solver="auto", TASDeviceFillCounts)
TAS_MIXED_RUNS = (("auto", True, False), ("auto_fill", True, True),
                  ("host_fill", False, True), ("host", False, False))
#: each run's depth: the auto runs on the store's first 1,500 workloads
#: (cut from 15,000 for chip_smoke.py's time)
TAS_MIXED_WORKLOADS = {"auto": 1500, "auto_fill": 1500,
                       "host_fill": 15000, "host": 15000}


#: phase 12's depth: the TAS drain store's first 1,500 workloads (phase
#: 4's cut; they hold all 102 admissions of the full store)
TAS_WORKLOADS = 1500


def reference_pins(*, storm_scale: float = 1.0, storm_cohorts: int = 5,
                   storm_cqs: int = 6, tas_kwargs=None,
                   tas_mixed_kwargs=None) -> dict:
    """The JAX package's records of phases 11-14 (full size by
    default, but phase 12 at ``TAS_WORKLOADS`` and phase 14's runs at
    ``TAS_MIXED_WORKLOADS``)."""
    jax = jax_package()
    storm = dict(n_cohorts=storm_cohorts, cqs_per_cohort=storm_cqs,
                 scale=storm_scale)
    return {
        "storm": run_waves(jax, scenarios.baseline_preempt_store,
                           solver=True, **storm),
        "storm_host": run_waves(jax, scenarios.baseline_preempt_store,
                                solver=False, **storm),
        "tas": run_tas(jax, **(tas_kwargs
                               or {"n_workloads": TAS_WORKLOADS})),
        "refused": run_waves(jax, scenarios.refused_quantity_store,
                             solver=True, **storm),
        "tas_mixed": {name: run_tas_mixed(
            jax, solver=solver, fill=fill,
            **(tas_mixed_kwargs
               or {"n_workloads": TAS_MIXED_WORKLOADS[name]}))
            for name, solver, fill in TAS_MIXED_RUNS},
    }


if __name__ == "__main__":
    pins = reference_pins()
    print(json.dumps(pins, indent=1))
