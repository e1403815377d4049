"""Simulator: arrival → admission → fake execution → finish.

A copy of ``kueue_oss_tpu/perf/runner.py`` over the port's scheduler.
Reference parity: test/performance/scheduler/runner — drives the
scheduler against generated workloads with a simulated clock, marks
admitted workloads Finished after their runtime, and collects the
rangespec metrics (total wall time, per-class avg time-to-admission,
min CQ usage, admission throughput).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.perf.generator import GeneratedWorkload
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler


@dataclass
class SimStats:
    total_workloads: int = 0
    admitted: int = 0
    finished: int = 0
    sim_wall_ms: float = 0.0       # simulated makespan
    real_seconds: float = 0.0      # host wall-clock spent scheduling
    cycles: int = 0
    tta_ms_by_class: dict[str, float] = field(default_factory=dict)
    admissions_per_real_second: float = 0.0
    preemptions: int = 0

    def summary(self) -> str:
        ttas = ", ".join(f"{k}={v:.0f}ms"
                         for k, v in sorted(self.tta_ms_by_class.items()))
        return (f"workloads={self.total_workloads} admitted={self.admitted} "
                f"finished={self.finished} cycles={self.cycles} "
                f"sim_makespan={self.sim_wall_ms / 1000:.1f}s "
                f"real={self.real_seconds:.2f}s "
                f"throughput={self.admissions_per_real_second:.0f}/s "
                f"avg_tta[{ttas}]")


class Simulator:
    """Event-driven simulation around the scheduler.

    The simulated clock jumps between events (arrivals, finishes); each
    event batch is followed by scheduler cycles until quiescence. This is
    the e2e slice: workloads flow queue → snapshot → assign → admit →
    finish, releasing quota that wakes parked workloads. ``solver=None``
    runs host cycles only and touches no device; ``solver="auto"``
    drains floods on ``device``.
    """

    def __init__(self, store: Store, schedule: list[GeneratedWorkload],
                 enable_fair_sharing: bool = False, solver=None,
                 timed_hooks=None, device="cuda") -> None:
        self.store = store
        self.schedule = schedule
        #: [(at_ms, fn(simulator, now_ms))] — virtual-time injection
        #: points; hooks run inside the event loop at their timestamp,
        #: before the scheduler runs to quiescence at that instant
        self.timed_hooks = list(timed_hooks or [])
        self.queues = QueueManager(store)
        self.scheduler = Scheduler(store, self.queues,
                                   enable_fair_sharing=enable_fair_sharing,
                                   solver=solver, device=device)
        if solver is not None:
            # one padded workload axis for every drain of the run: pad
            # to the schedule's peak instead of growing at each
            # power-of-two crossing as the backlog grows
            engine = self.scheduler._solver_engine()
            if engine is not None:
                engine.pad_to = len(schedule)
        self.by_key = {g.workload.key: g for g in schedule}
        #: workload keys touched since the last admission/eviction sweep —
        #: keeps the sweep O(changed) instead of O(all workloads)
        self._dirty: set[str] = set()
        store.watch(self._on_event)

    def _on_event(self, event) -> None:
        verb, kind, obj = event
        if kind == "Workload":
            self._dirty.add(obj.key)

    def run(self, max_events: int = 10_000_000) -> SimStats:
        stats = SimStats(total_workloads=len(self.schedule))
        t_real0 = time.monotonic()
        now_ms = 0.0
        #: (time_ms, seq, kind, payload)
        events: list = []
        seq = 0
        for g in self.schedule:
            events.append((g.arrival_ms, seq, "arrive", g))
            seq += 1
        for at_ms, fn in self.timed_hooks:
            events.append((float(at_ms), seq, "hook", fn))
            seq += 1
        heapq.heapify(events)
        admitted_at: dict[str, float] = {}
        tta_sum: dict[str, float] = {}
        tta_n: dict[str, int] = {}

        processed = 0
        pending_wake: set[float] = set()
        while events and processed < max_events:
            now_ms, _, kind, payload = heapq.heappop(events)
            processed += 1
            batch = [(kind, payload)]
            # absorb events at the same timestamp
            while events and events[0][0] <= now_ms:
                _, _, k2, p2 = heapq.heappop(events)
                batch.append((k2, p2))
                processed += 1
            for k, g in batch:
                if k == "arrive":
                    self.store.add_workload(g.workload)
                elif k == "hook":
                    g(self, now_ms)
                elif k == "finish":
                    g, admit_ts = g
                    # stale if the workload was preempted since admission
                    if admitted_at.get(g.workload.key) != admit_ts:
                        continue
                    self.scheduler.finish_workload(g.workload.key,
                                                   now=now_ms / 1000.0)
                    stats.finished += 1
                # "wake": no payload action; requeue_due below handles it

            # eviction backoffs that expired become schedulable now
            self.scheduler.requeue_due(now_ms / 1000.0)

            # run scheduler to quiescence at this instant
            cycles = self.scheduler.run_until_quiet(now=now_ms / 1000.0)
            stats.cycles += cycles

            # record admissions/evictions, schedule finish + wake events
            dirty, self._dirty = self._dirty, set()
            for key in dirty:
                wl = self.store.workloads.get(key)
                if wl is None:
                    continue
                if wl.is_quota_reserved and key not in admitted_at:
                    admitted_at[key] = now_ms
                    g = self.by_key[key]
                    tta = now_ms - g.arrival_ms
                    tta_sum[g.class_name] = tta_sum.get(g.class_name, 0) + tta
                    tta_n[g.class_name] = tta_n.get(g.class_name, 0) + 1
                    stats.admitted += 1
                    heapq.heappush(
                        events,
                        (now_ms + g.runtime_ms, seq, "finish", (g, now_ms)))
                    seq += 1
                elif not wl.is_quota_reserved and key in admitted_at:
                    # evicted/preempted: track re-admission afresh
                    del admitted_at[key]
                    stats.admitted -= 1
                    stats.preemptions += 1
            next_requeue = self.scheduler.next_requeue_at()
            if next_requeue is not None:
                wake_ms = next_requeue * 1000.0
                if wake_ms not in pending_wake:
                    pending_wake.add(wake_ms)
                    heapq.heappush(events, (wake_ms, seq, "wake", None))
                    seq += 1

        stats.sim_wall_ms = now_ms
        stats.real_seconds = time.monotonic() - t_real0
        stats.tta_ms_by_class = {
            k: tta_sum[k] / tta_n[k] for k in tta_sum}
        if stats.real_seconds > 0:
            stats.admissions_per_real_second = (
                stats.admitted / stats.real_seconds)
        return stats


def drain_benchmark(store: Store, schedule: list[GeneratedWorkload],
                    device="cuda") -> dict:
    """Backlog-drain benchmark through the device solver: all workloads
    pending at t0, one lean ``solve_backlog`` computes the full plan.

    Returns a dict with solver timing and throughput. The store must not
    have preemption-enabled CQs (use GeneratorConfig(..., preemption
    disabled) shapes). The solve is timed from the call to the
    synchronize after it, so it includes the first launches of a fresh
    process; warm the device first for a steady-state time. (The JAX
    version's ahead-of-time compile has no counterpart: nothing here
    compiles.)
    """
    import torch

    from kueue_oss_tpu_torch.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device

    for g in schedule:
        store.add_workload(g.workload)
    queues = QueueManager(store)
    engine = SolverEngine(store, queues, device=device)
    problem, _ = engine.export()
    tensors = to_device(problem, engine.device)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    sync()
    t0 = time.monotonic()
    out = solve_backlog(tensors)
    sync()
    solve_s = time.monotonic() - t0
    admitted, opt, admit_round, parked, rounds, usage = out
    n_admitted = int(admitted.sum())
    return {
        "workloads": problem.n_workloads,
        "cluster_queues": problem.n_cqs,
        "admitted": n_admitted,
        "rounds": int(rounds),
        "solve_seconds": solve_s,
        "admissions_per_second": n_admitted / solve_s if solve_s else 0.0,
        "cycle_ms": solve_s * 1000.0 / max(int(rounds), 1),
    }
