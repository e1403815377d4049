"""The what-if engine: scenarios in, one batched drain, report out.

A copy of the lean path of ``kueue_oss_tpu/sim/engine.py``.
``WhatIfEngine`` wires the three layers together:

1. scenario layer (sim/scenario.py) — declarative ``ScenarioSpec``
   perturbations over a base store/backlog;
2. batched solve layer (sim/batch.py + kernels.solve_backlog_batched) —
   S counterfactual admission problems in ONE batched device drain,
   with the sequential single-problem drain kept as the bit-identical
   parity oracle;
3. report layer (sim/report.py) — per-scenario KPIs (admissions,
   utilization, fairness drift, starvation ages) in a deterministic
   JSON report.

Two execution modes:

- :meth:`WhatIfEngine.run` — the batched counterfactual sweep over the
  CURRENT backlog (quota scaling, arrival-rate churn, priority mixes).
- :func:`simulate_trace` — a full virtual-time trace simulation (the
  perf Simulator driving the real scheduler) for ONE scenario.

``run(full=True)`` (or ``SimulatorConfig.full_kernel``) routes the
sweep through the FULL preemption drain in lane-budgeted chunks
(sim/batch.py ``solve_scenarios_tiered``), with the resident device
state of sim/resident.py when the engine is built ``resident=True``.

Everything is deterministic: same store, same specs, same seeds =>
byte-identical ``WhatIfReport.canonical_json()``. Cut from the copy:
the scenario-axis mesh (ROADMAP Queue A item 9), node flaps in trace
mode (item 11), and the ``metrics.whatif_*`` observations (the port has
no metrics layer).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.config.configuration import SimulatorConfig
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.sim.batch import (
    FULL_TIER,
    LaneBudget,
    check_parity,
    check_parity_full,
    full_caps,
    solve_scenarios,
    solve_scenarios_bucketed,
    solve_scenarios_sequential,
    solve_scenarios_sequential_full,
    solve_scenarios_tiered,
    sweep_order,
)
from kueue_oss_tpu_torch.sim.report import WhatIfReport, scenario_kpis
from kueue_oss_tpu_torch.sim.scenario import (
    ScenarioSpec,
    arrival_order,
    max_arrival_scale,
)
from kueue_oss_tpu_torch.solver.full_kernels import to_device_full
from kueue_oss_tpu_torch.solver.kernels import to_device
from kueue_oss_tpu_torch.solver.tensors import (
    ExportCache,
    export_problem,
    pad_workloads,
    pow2,
)


def pending_backlog(store: Store, queues=None,
                    ) -> dict[str, list[WorkloadInfo]]:
    """The pending backlog per CQ for a what-if export.

    With a ``QueueManager``, heap entries AND parked (inadmissible)
    workloads merge in ``_order_key`` order — a counterfactual that
    frees capacity would flush parked entries back into exactly that
    order, and capacity planning is mostly ABOUT the parked backlog;
    without one, every unadmitted active workload grouped per CQ in
    (creation ts, uid) order. Both paths therefore answer the same
    question over the same store. TAS-shaped workloads are excluded —
    the lean drain the batch runs does not place topologies.
    """
    out: dict[str, list[WorkloadInfo]] = {}
    if queues is not None:
        from kueue_oss_tpu_torch.core.queue_manager import _order_key

        for name, q in queues.queues.items():
            if not q.active:
                continue
            # heap and inadmissible are disjoint; a counterfactual
            # reconsiders BOTH (stale or not — changed capacity would
            # flush them all eventually)
            infos = (list(q.snapshot_order())
                     + list(q.inadmissible.values()))
            infos = [i for i in infos
                     if all(ps.topology_request is None
                            for ps in i.obj.podsets)]
            if infos:
                out[name] = sorted(infos, key=_order_key)
        return out
    by_cq: dict[str, list] = {}
    for wl in store.workloads.values():
        if (wl.status.admission is not None or not wl.active
                or wl.is_finished):
            continue
        if any(ps.topology_request is not None for ps in wl.podsets):
            continue
        lq = store.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        if lq is None or lq.cluster_queue not in store.cluster_queues:
            continue
        # stopped CQs admit nothing — same exclusion the QueueManager
        # path applies via q.active, so both paths agree on the store
        if store.cluster_queues[lq.cluster_queue].stop_policy != "None":
            continue
        by_cq.setdefault(lq.cluster_queue, []).append(wl)
    for name, wls in sorted(by_cq.items()):
        wls.sort(key=lambda w: (w.creation_time, w.uid, w.key))
        out[name] = [WorkloadInfo(w, cluster_queue=name) for w in wls]
    return out


def _materialize_replicas(pending: dict[str, list[WorkloadInfo]],
                          replicas: int,
                          ) -> dict[str, list[WorkloadInfo]]:
    """Clone every pending workload ``replicas - 1`` times for
    arrival_scale > 1 sweeps. Clones are synthetic WorkloadInfo rows
    (never added to the store), arriving strictly AFTER every original
    so per-CQ arrival order keeps originals first; scenarios mask the
    union down to their own cutoff."""
    import dataclasses

    from kueue_oss_tpu_torch.api.types import WorkloadStatus

    if replicas <= 1:
        return pending
    t_max = max((i.obj.creation_time for infos in pending.values()
                 for i in infos), default=0.0)
    uid_max = max((i.obj.uid for infos in pending.values()
                   for i in infos), default=0)
    out: dict[str, list[WorkloadInfo]] = {}
    next_uid = int(uid_max) + 1
    for name in sorted(pending):
        infos = list(pending[name])
        originals = list(infos)
        for j in range(1, replicas):
            for k, info in enumerate(originals):
                wl = info.obj
                clone = dataclasses.replace(
                    wl,
                    name=f"{wl.name}~whatif{j}",
                    uid=next_uid,
                    creation_time=(t_max + 1.0 + j
                                   + k / max(1, len(originals))),
                    # a fresh status: dataclasses.replace would share
                    # the original's mutable status object otherwise
                    status=WorkloadStatus(),
                )
                next_uid += 1
                infos.append(WorkloadInfo(clone, cluster_queue=name))
        out[name] = infos
    return out


class WhatIfEngine:
    """Batched counterfactual simulation over a live (or generated)
    store, on ``device`` (``"cuda"`` by default; raises without CUDA).
    Construction is cheap; every :meth:`run` exports fresh, except that
    ``resident=True`` keeps the FULL sweeps' padded base tensors on the
    device across runs (sim/resident.py)."""

    def __init__(self, store: Store, queues=None, config=None,
                 now: Optional[float] = None,
                 resident: bool = False, device="cuda") -> None:
        self.store = store
        self.queues = queues
        self.config = config if config is not None else SimulatorConfig()
        self.device = resolve_device(device)
        #: optional scenario-resident device state for FULL sweeps
        self.resident = None
        if resident:
            from kueue_oss_tpu_torch.sim.resident import ResidentSweep

            self.resident = ResidentSweep(store, device=self.device)
        #: planning instant for age KPIs. None (default) derives it
        #: from the export itself — the newest pending creation
        #: timestamp — so starvation ages are meaningful RELATIVE queue
        #: ages on live stores (epoch-seconds timestamps) while the
        #: report stays deterministic (no wall clock leaks in).
        self.now = now

    def run(self, specs: list[ScenarioSpec],
            pending: Optional[dict[str, list[WorkloadInfo]]] = None,
            parity: Optional[int] = None,
            full: Optional[bool] = None) -> WhatIfReport:
        """Solve every scenario in one batched drain (one per round
        bucket); return the report. Raises UnsupportedProblem for
        stores the drains cannot model.

        ``full`` routes the sweep through the FULL preemption drain
        (lane-budgeted chunks, sim/batch.py) instead of the lean
        fit-only batch; ``None`` defers to ``config.full_kernel``. FULL
        sweeps export admitted rows too (preemption candidates), report
        real preemption counts, and may re-tier overflow scenarios to
        the relax LP — always reported per row (``tier``), never
        silently."""
        if not specs:
            raise ValueError("need at least one ScenarioSpec")
        if len(specs) > self.config.max_scenarios:
            raise ValueError(
                f"{len(specs)} scenarios exceed simulator.maxScenarios="
                f"{self.config.max_scenarios}")
        for spec in specs:
            spec.validate()
        t0 = time.monotonic()
        if pending is None:
            pending = pending_backlog(self.store, self.queues)
        now = self.now
        if now is None:
            # deterministic planning instant: the newest ORIGINAL
            # pending creation timestamp (before clone
            # materialization, so a spec's KPIs never depend on which
            # unrelated scenarios share the batch)
            now = max((i.obj.creation_time
                       for infos in pending.values() for i in infos),
                      default=0.0)
        use_full = (self.config.full_kernel if full is None
                    else bool(full))
        replicas = int(np.ceil(max_arrival_scale(specs)))
        pending = _materialize_replicas(pending, replicas)
        full_tensors = None
        if use_full and self.resident is not None:
            # the resident session exports, pads, and syncs the device
            # tensors in one step (reuse / row scatter / full upload)
            problem, full_tensors = self.resident.refresh(pending=pending)
            n_real = self.resident.last_real_workloads
        else:
            problem = export_problem(self.store, pending,
                                     include_admitted=use_full,
                                     cache=ExportCache(self.store,
                                                       subscribe=False))
            n_real = problem.n_workloads
        report = WhatIfReport()
        report.base = {
            "workloads": n_real,
            "cluster_queues": problem.n_cqs,
            "nodes": problem.n_nodes,
            "flavors": len(problem.fr_list),
            "arrival_replicas": replicas,
            "scenarios": len(specs),
            "tier": "full" if use_full else "lean",
        }
        if n_real == 0:
            report.parity = {"checked": 0, "identical": True,
                             "mismatches": []}
            return report
        if full_tensors is None:
            problem = pad_workloads(problem, pow2(problem.n_workloads))
        report.base["padded_workloads"] = problem.n_workloads
        # the O(W) arrival ordering depends only on the base problem;
        # compute it once for the whole sweep
        need_arrival = (replicas > 1
                        or any(s.arrival_scale != 1.0 for s in specs))
        arrival_idx = arrival_order(problem) if need_arrival else None
        overlays = [spec.overlay(problem, replicas=replicas,
                                 arrival_idx=arrival_idx)
                    for spec in specs]
        build_s = time.monotonic() - t0

        if use_full:
            caps = full_caps(problem)
            if full_tensors is None:
                full_tensors = to_device_full(problem, self.device)
            budget = LaneBudget(
                budget_bytes=self.config.lane_budget_mb << 20,
                max_full_scenarios=self.config.full_sweep_max)
            batch = solve_scenarios_tiered(
                problem, overlays, budget=budget, caps=caps,
                tensors=full_tensors,
                relax_iters=self.config.relax_iters,
                pad_pow2=self.config.pad_pow2,
                order=sweep_order(specs))
            bucket_stats = {}
            n_dispatches = max(1, len(batch.chunks)
                               + (1 if batch.retier_idx else 0))
            report.base["full_caps"] = {"g_max": caps[0],
                                        "h_max": caps[1],
                                        "p_max": caps[2]}
            if batch.retier_idx:
                # WHICH rows were approximated, and why (the planner's
                # log line fires in LaneBudget.plan)
                report.base["retier"] = {
                    "reason": batch.retier_reason,
                    "scenarios": [specs[i].name
                                  for i in batch.retier_idx],
                    "indices": list(batch.retier_idx),
                }
        else:
            # one upload of the shared base problem serves every batched
            # drain and the parity oracle
            lean_tensors = to_device(problem, self.device)
            if self.config.round_bucketing:
                # round-skew bucketing: short scenarios stop riding the
                # batch to the slowest lane's round count
                batch, bucket_stats, n_dispatches = (
                    solve_scenarios_bucketed(
                        problem, overlays, tensors=lean_tensors,
                        pad_pow2=self.config.pad_pow2,
                        min_batch=self.config.min_batch_for_bucketing))
            else:
                batch = solve_scenarios(problem, overlays,
                                        tensors=lean_tensors,
                                        pad_pow2=self.config.pad_pow2)
                bucket_stats, n_dispatches = {}, 1

        n_parity = (self.config.parity_scenarios
                    if parity is None else parity)
        parity_s = 0.0
        if n_parity > 0:
            t1 = time.monotonic()
            if use_full:
                # parity is defined against the sequential FULL oracle,
                # so only exactly-solved rows participate — relax-tier
                # rows are approximate BY DECLARATION (tier="relax")
                idx = [i for i, t in enumerate(batch.tier)
                       if t == FULL_TIER][:n_parity]
                seq = solve_scenarios_sequential_full(
                    problem, [overlays[i] for i in idx], *caps,
                    tensors=full_tensors) if idx else None
                pr = (check_parity_full(batch, seq, idx) if idx
                      else check_parity(batch, batch, []))
            else:
                idx = list(range(min(n_parity, len(specs))))
                seq = solve_scenarios_sequential(
                    problem, [overlays[i] for i in idx],
                    tensors=lean_tensors)
                pr = check_parity(batch, seq, idx)
            parity_s = time.monotonic() - t1
            report.parity = {"checked": pr.checked,
                             "identical": pr.identical,
                             "mismatches": pr.mismatches}
        else:
            report.parity = {"checked": 0, "identical": True,
                             "mismatches": []}

        t2 = time.monotonic()
        for spec, overlay, i in zip(specs, overlays, range(len(specs))):
            kw = {}
            if use_full:
                kw = {"tier": batch.tier[i],
                      "victim_reason": batch.victim_reason[i]
                      if batch.tier[i] == FULL_TIER else None}
            report.scenarios.append(scenario_kpis(
                problem, spec, overlay,
                batch.admitted[i], batch.opt[i], batch.admit_round[i],
                batch.parked[i], batch.rounds[i], batch.usage[i],
                now=now, **kw))
        report_s = time.monotonic() - t2
        report.timing = {
            "build_seconds": round(build_s, 6),
            "solve_seconds": round(batch.solve_seconds, 6),
            "parity_seconds": round(parity_s, 6),
            "report_seconds": round(report_s, 6),
            "batch_width": batch.batch_width,
            "batch_dispatches": n_dispatches,
            "round_buckets": {str(b): n
                              for b, n in sorted(bucket_stats.items())},
            "full_chunks": list(getattr(batch, "chunks", [])),
            "scenarios_per_sec": round(
                len(specs) / batch.solve_seconds, 2)
            if batch.solve_seconds > 0 else 0.0,
            "host_reads": batch.host_reads,
        }
        return report


def simulate_trace(store: Store, schedule, spec: ScenarioSpec,
                   enable_fair_sharing: bool = False,
                   solver=None, device="cuda") -> dict:
    """Virtual-time trace simulation of ONE scenario through the real
    scheduler (perf Simulator): arrival-rate scaling compresses or
    stretches the arrival timeline and priority perturbations apply to
    the generated workloads. ``store``/``schedule`` must be a fresh
    generated pair (perf.generator.generate); the simulation consumes
    them. Node-flap schedules wait for the TAS controllers (ROADMAP
    Queue A item 11).
    """
    import fnmatch

    from kueue_oss_tpu_torch.perf.runner import Simulator

    spec.validate()
    if spec.node_flaps:
        raise NotImplementedError(
            "simulate_trace with node_flaps: the node-flap injector "
            "belongs with the TAS controllers, ROADMAP Queue A item 11")
    rng = np.random.default_rng(spec.seed)
    scale = spec.arrival_scale
    if scale <= 0:
        schedule = []
    else:
        for g in schedule:
            g.arrival_ms = g.arrival_ms / scale
            g.workload.creation_time = g.arrival_ms / 1000.0
    if spec.priority_shift:
        lq_to_cq = {lq.name: lq.cluster_queue
                    for lq in store.local_queues.values()}
        for g in schedule:
            cq = lq_to_cq.get(g.workload.queue_name, "")
            for pat, delta in spec.priority_shift.items():
                if fnmatch.fnmatchcase(cq, pat):
                    g.workload.priority += int(delta)
    if spec.priority_churn_fraction > 0 and spec.priority_churn_delta:
        n_pick = int(round(spec.priority_churn_fraction * len(schedule)))
        if n_pick:
            for i in rng.choice(len(schedule), size=n_pick,
                                replace=False):
                schedule[i].workload.priority += spec.priority_churn_delta

    sim = Simulator(store, schedule,
                    enable_fair_sharing=enable_fair_sharing,
                    solver=solver, device=device)
    stats = sim.run()
    return {
        "name": spec.name,
        "spec": spec.to_dict(),
        "workloads": stats.total_workloads,
        "admitted": stats.admitted,
        "finished": stats.finished,
        "preemptions": stats.preemptions,
        "cycles": stats.cycles,
        "sim_wall_ms": round(stats.sim_wall_ms, 3),
        "tta_ms_by_class": {k: round(v, 3)
                            for k, v in sorted(
                                stats.tta_ms_by_class.items())},
        "node_flaps": [],
    }
