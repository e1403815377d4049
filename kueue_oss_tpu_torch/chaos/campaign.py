"""Composed-fault chaos campaigns with a convergence oracle.

A copy of ``kueue_oss_tpu/chaos/campaign.py``: the same profiles, storm
schedules and oracle, so a seed gives the JAX package's record (its
wall time aside). The planes' solver drains run on ``spec.device``
("cuda" unless the caller asks for the CPU). The port's Scheduler has
no injectable clock (it reads one only for cycle durations): the
campaign's virtual clock drives the ladder's cooldowns and the breaker.

The injectors in :mod:`kueue_oss_tpu_torch.chaos` each prove one failure mode
in isolation. Real incidents are not that polite: a pod loss lands
while the solver mesh is half-broken and the disk is sick. A
**campaign** composes several injectors into a seeded multi-fault storm
against a live control plane and then asks the question none of the
single-fault tests can: *after the storm passes, does the system
converge back to exactly the state a fault-free run would have
produced?*

The convergence oracle (docs/ROBUSTNESS.md "Chaos campaigns"):

1. **Byte identity** — a fault-free *twin* plane replays the same
   external trace (arrivals, node flaps) with no injected faults; after
   the storm the faulted plane's store must become bit-identical to the
   twin's (``persist.codec.canonical_dump``) within
   ``convergence_bound`` recovery cycles. This works because parked /
   skipped workloads get no store writes, every admission writes
   exactly once with fixed reason strings regardless of the arm that
   found it (host cycle, batched solve, streamed micro-drain), and the
   campaign drives a constant virtual ``now`` — so *when* and *how* a
   workload was admitted leaves no residue, only *that* it was.
2. **Zero invariant violations** — ``persist.auditor.InvariantAuditor``
   over the converged store.
3. **Monotone recovery** — once the storm ends, the max degradation
   level (:mod:`kueue_oss_tpu_torch.resilience`) never rises again and ends
   at 0; every transition is on the controller's history for the
   bench tail / assertions.

Everything is deterministic: faults and flap schedules are drawn from
``random.Random(seed)`` at plan time, the controller's cooldown clock
is virtual (stepped ``clock_step_s`` per cycle, so half-open re-probes
heal on a driven schedule), and availability wall time is the only
real-clock read (reporting only, never control flow).

Each plane runs under its own :class:`resilience.DegradationController`
(via ``resilience.use``), so a campaign never leaks degraded state into
the process-wide controller, and twin/faulted ladders cannot alias.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional

from kueue_oss_tpu_torch import resilience
from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    Node,
    PodSet,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.persist.auditor import InvariantAuditor
from kueue_oss_tpu_torch.persist.codec import canonical_dump
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable

SOLVER_STORM = "solver-storm"
POD_LOSS = "pod-loss"
FED_PARTITION = "fed-partition"
KILL_STORM = "kill-storm"

#: every campaign profile bench.py's chaoscampaign scenario sweeps
PROFILES = (SOLVER_STORM, POD_LOSS, FED_PARTITION, KILL_STORM)

#: which degradation subsystem each profile storms — the smoke tests
#: assert transition events landed HERE, not just somewhere
PROFILE_SUBSYSTEM = {
    SOLVER_STORM: resilience.SOLVER,
    POD_LOSS: resilience.STREAMING,
    FED_PARTITION: resilience.FEDERATION,
    KILL_STORM: resilience.PERSISTENCE,
}


@dataclass
class CampaignSpec:
    """One seeded campaign: shape, storm schedule, oracle bounds."""

    profile: str
    seed: int = 0
    #: cycles under fire; arrivals are spread across these
    storm_cycles: int = 12
    #: recovery cycles the oracle allows before declaring divergence
    convergence_bound: int = 16
    n_cqs: int = 4
    quota: int = 32
    #: total demand; must fit capacity (n_cqs * quota) so the twin's
    #: terminal state is "everything admitted" — the oracle's anchor
    n_workloads: int = 96
    n_nodes: int = 4
    #: the constant virtual admission clock (byte identity needs every
    #: plane to stamp the same ``now`` into conditions)
    now: float = 1000.0
    #: virtual seconds per cycle on the controller clock — drives the
    #: half-open cooldown probes (mesh retry, WAL restore)
    clock_step_s: float = 30.0
    #: kill-storm: directory for the durable plane (required there)
    persistence_dir: Optional[str] = None
    #: where the planes' solver drains run
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.profile not in PROFILES:
            raise ValueError(
                f"unknown profile {self.profile!r}; one of {PROFILES}")
        if self.n_workloads > self.n_cqs * self.quota:
            raise ValueError("campaign demand must fit capacity "
                             "(the twin must terminate fully admitted)")
        if self.profile == KILL_STORM and not self.persistence_dir:
            raise ValueError("kill-storm needs spec.persistence_dir")


@dataclass
class CampaignResult:
    profile: str
    seed: int
    converged: bool = False
    #: recovery cycles until byte identity + level 0 (0 = converged at
    #: the heal boundary); convergence_bound when it never did
    convergence_cycles: int = 0
    recovered_identical: bool = False
    #: kill-storm only: close + recover from disk == live store
    durable_identical: Optional[bool] = None
    max_degradation_level: int = 0
    #: admitting cycles / cycles with eligible pending work
    availability: float = 1.0
    unavailable_cycles: int = 0
    unavailable_wall_ms: float = 0.0
    invariant_violations: int = 0
    monotone_recovery: bool = True
    levels_zero: bool = False
    faults_injected: int = 0
    transitions: dict = field(default_factory=dict)
    twin_cycles: int = 0
    storm_cycles: int = 0

    @property
    def ok(self) -> bool:
        """The full oracle: converged bit-identical, clean audit,
        monotone recovery, ladder back at 0 (and the durable state
        agreeing, where a durable plane ran)."""
        return (self.converged and self.recovered_identical
                and self.invariant_violations == 0
                and self.monotone_recovery and self.levels_zero
                and self.durable_identical is not False)

    def to_dict(self) -> dict:
        return {
            "profile": self.profile,
            "seed": self.seed,
            "converged": self.converged,
            "convergence_cycles": self.convergence_cycles,
            "recovered_identical": self.recovered_identical,
            "durable_identical": self.durable_identical,
            "max_degradation_level": self.max_degradation_level,
            "availability": round(self.availability, 4),
            "unavailable_cycles": self.unavailable_cycles,
            "unavailable_wall_ms": round(self.unavailable_wall_ms, 3),
            "invariant_violations": self.invariant_violations,
            "monotone_recovery": self.monotone_recovery,
            "levels_zero": self.levels_zero,
            "faults_injected": self.faults_injected,
            "transitions": dict(self.transitions),
            "twin_cycles": self.twin_cycles,
            "storm_cycles": self.storm_cycles,
        }


class _Plane:
    """One live control plane (store + scheduler [+ engine/persist])."""

    def __init__(self, spec: CampaignSpec, clock,
                 persistence: bool = False) -> None:
        self.spec = spec
        self.store = Store()
        self.manager = None
        if persistence:
            from kueue_oss_tpu_torch.persist.manager import PersistenceManager

            # attach BEFORE seeding: only watched events reach the WAL,
            # and the seed objects must be recoverable too
            self.manager = PersistenceManager(
                spec.persistence_dir, fsync="always")
            self.manager.attach(self.store)
            # restore probes on the campaign's virtual cadence
            self.manager.wal.restore_cooldown_s = 2 * spec.clock_step_s
        self.store.upsert_resource_flavor(ResourceFlavor(name="f"))
        for i in range(spec.n_nodes):
            self.store.upsert_node(Node(
                name=f"node{i}", allocatable={"cpu": 1_000_000}))
        for i in range(spec.n_cqs):
            self.store.upsert_cluster_queue(ClusterQueue(
                name=f"cq{i}", resource_groups=[ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[FlavorQuotas(name="f", resources=[
                        ResourceQuota(name="cpu",
                                      nominal=spec.quota)])])]))
            self.store.upsert_local_queue(LocalQueue(
                name=f"lq{i}", cluster_queue=f"cq{i}"))
        self.queues = QueueManager(self.store)
        solver = spec.profile in (SOLVER_STORM, POD_LOSS)
        self.sched = Scheduler(
            self.store, self.queues,
            solver="auto" if solver else None,
            solver_min_backlog=0,
            streaming=(spec.profile == POD_LOSS), device=spec.device)
        self.engine = self.sched._solver_engine() if solver else None
        if self.engine is not None:
            self.engine.health.clock = clock
        self.arrived = 0

    def admitted(self) -> int:
        return sum(1 for w in self.store.workloads.values()
                   if w.is_quota_reserved)

    def step(self, now: float, full_solve: bool = True) -> int:
        """One admission pass through every configured arm; returns
        workloads newly admitted. ``full_solve=False`` keeps the cycle
        on the streamed micro-drain path (pod-loss storms stretch the
        armed window across several cycles so node flaps land MID
        window and trip the structural/stream fences)."""
        before = self.admitted()
        if self.engine is not None:
            if full_solve:
                try:
                    self.engine.drain(now=now, verify=True)
                except SolverUnavailable:
                    pass  # the storm's point: host cycles must carry on
            if self.spec.profile == POD_LOSS:
                self.sched.micro_drain(now)
                if not full_solve:
                    return self.admitted() - before
        self.sched.schedule(now=now)
        return self.admitted() - before


class ChaosCampaign:
    """Run one :class:`CampaignSpec` end to end and judge convergence.

    The fault-free twin runs FIRST (its terminal dump is the oracle's
    target), then the faulted plane: storm cycles with composed
    injected faults, an explicit heal (the chaos source goes away —
    recovery itself still rides the controller's cooldown probes),
    then recovery cycles until byte identity or the bound.
    """

    def __init__(self, spec: CampaignSpec) -> None:
        self.spec = spec
        rng = random.Random(spec.seed)
        #: cycle -> [(workload name, lq index)] — shared external trace
        self.arrivals: dict[int, list] = {}
        for i in range(spec.n_workloads):
            c = i * spec.storm_cycles // spec.n_workloads
            self.arrivals.setdefault(c, []).append(
                (f"w{i}", i % spec.n_cqs, i + 1, float(i)))
        #: cycle -> [(op, node name)] — replayed in BOTH planes (the
        #: flap is an external event; the twin sees the same cluster)
        self.flaps: dict[int, list] = {}
        if spec.profile == POD_LOSS:
            for c in range(0, max(1, spec.storm_cycles - 2), 3):
                name = f"node{rng.randrange(spec.n_nodes)}"
                self.flaps.setdefault(c, []).append(("down", name))
                self.flaps.setdefault(c + 2, []).append(("up", name))
        #: cycle -> [fault action] — the storm schedule (faulted only)
        self.fault_plan: dict[int, list] = {}
        if spec.profile == SOLVER_STORM:
            for c in range(spec.storm_cycles):
                for _ in range(1 + (rng.random() < 0.5)):
                    self.fault_plan.setdefault(c, []).append(rng.choice(
                        ("mesh", "all", "breaker", "relax")))
        elif spec.profile == FED_PARTITION:
            for c in range(spec.storm_cycles):
                if rng.random() < 0.6:
                    self.fault_plan.setdefault(c, []).append(
                        ("throttle", rng.choice(("blue", "red"))))
        elif spec.profile == KILL_STORM:
            for c in range(spec.storm_cycles):
                if rng.random() < 0.5:
                    self.fault_plan.setdefault(c, []).append("fsync")
            self.fault_plan.setdefault(
                spec.storm_cycles // 2, []).append("crash")
        self._vnow = 0.0
        self.result = CampaignResult(
            profile=spec.profile, seed=spec.seed,
            storm_cycles=spec.storm_cycles,
            convergence_cycles=spec.convergence_bound)

    # virtual controller/scheduler clock (injected everywhere)
    def _clock(self) -> float:
        return self._vnow

    # -- trace replay -------------------------------------------------

    def _apply_trace(self, plane: _Plane, cycle: int) -> None:
        for name, lq, uid, t in self.arrivals.get(cycle, ()):
            plane.store.add_workload(Workload(
                name=name, queue_name=f"lq{lq}", uid=uid,
                creation_time=t,
                podsets=[PodSet(name="main", count=1,
                                requests={"cpu": 1})]))
            plane.arrived += 1
        for op, name in self.flaps.get(cycle, ()):
            node = plane.store.nodes[name]
            node.ready = op == "up"
            plane.store.upsert_node(node)

    # -- the twin -----------------------------------------------------

    def _run_twin(self) -> bytes:
        spec = self.spec
        self._vnow = 0.0
        with resilience.use(resilience.DegradationController(
                clock=self._clock)):
            plane = _Plane(spec, self._clock)
            cycle = 0
            while True:
                self._vnow += spec.clock_step_s
                self._apply_trace(plane, cycle)
                plane.step(spec.now)
                cycle += 1
                if (cycle >= spec.storm_cycles
                        and plane.admitted() >= spec.n_workloads):
                    break
                if cycle > spec.storm_cycles + 200:
                    raise RuntimeError(
                        "fault-free twin failed to quiesce — the "
                        "campaign shape is broken, not the plane")
            self.result.twin_cycles = cycle
            return canonical_dump(plane.store)

    # -- fault actions ------------------------------------------------

    def _inject(self, plane: _Plane, farm, mesh_inj, cycle: int) -> None:
        res = self.result
        for action in self.fault_plan.get(cycle, ()):
            res.faults_injected += 1
            if action == "mesh":
                mesh_inj.lose_mesh(1)
            elif action == "all":
                mesh_inj.lose_all(1)
            elif action == "breaker":
                for _ in range(plane.engine.health.failure_threshold):
                    plane.engine.health.record_failure()
            elif action == "relax":
                plane.engine._note_relax_failure(
                    RuntimeError("injected relax fault (campaign)"),
                    "relax_error")
            elif action == "fsync":
                plane.manager.wal.fsync_fault += 1
            elif action == "crash":
                from kueue_oss_tpu_torch.chaos import CrashPointInjector
                from kueue_oss_tpu_torch.persist import hooks

                with CrashPointInjector("mid_checkpoint", mode="raise"):
                    try:
                        plane.manager.checkpoint(force_full=True)
                    except hooks.CrashPoint:
                        pass  # the checkpoint died; WAL still rules
            elif isinstance(action, tuple) and action[0] == "throttle":
                farm.force_throttle(action[1], times=1)

    def _heal(self, plane: _Plane, farm, mesh_inj) -> None:
        """The chaos source stops. Conditions clear through the same
        paths production healing uses (probe fsyncs, refresh_mesh,
        breaker success, a served farm grant) — never by resetting the
        controller."""
        spec = self.spec
        if mesh_inj is not None:
            mesh_inj.restore()
            plane.engine.health.record_success()
            if resilience.controller.active(resilience.SOLVER,
                                            "relax_broken"):
                plane.engine._relax_broken = False
        if farm is not None:
            farm.throttle_fault.clear()
        if plane.manager is not None:
            plane.manager.wal.fsync_fault = 0

    def _drive_farm(self, farm) -> None:
        """The federated tenants' per-cycle solver calls: a throttled
        call surfaces in-band backpressure (raising the FEDERATION
        conditions); a served one clears them."""
        for tenant in ("blue", "red"):
            farm.run(tenant, lambda: ({"ok": True}, b""))

    # -- the faulted plane --------------------------------------------

    def run(self) -> CampaignResult:
        spec, res = self.spec, self.result
        twin_dump = self._run_twin()
        self._vnow = 0.0
        ctl = resilience.DegradationController(clock=self._clock)
        with resilience.use(ctl):
            plane = _Plane(spec, self._clock,
                           persistence=spec.profile == KILL_STORM)
            farm = None
            if spec.profile == FED_PARTITION:
                from kueue_oss_tpu_torch.federation.farm import FarmScheduler

                farm = FarmScheduler(clock=self._clock)
            mesh_inj = None
            if plane.engine is not None:
                from kueue_oss_tpu_torch.chaos import MeshFaultInjector

                mesh_inj = MeshFaultInjector(plane.engine)
                if spec.profile == POD_LOSS:
                    # pod-loss storms the streaming fences; the flap
                    # trace is the fault — count the down-flaps
                    res.faults_injected += sum(
                        1 for evs in self.flaps.values()
                        for op, _ in evs if op == "down")

            def cycle_once(cycle: int, inject: bool) -> None:
                self._vnow += spec.clock_step_s
                self._apply_trace(plane, cycle)
                if inject:
                    self._inject(plane, farm, mesh_inj, cycle)
                if farm is not None:
                    self._drive_farm(farm)
                # pod-loss storm cycles stay on the streamed window
                # between periodic full solves (see _Plane.step)
                full = not (inject and spec.profile == POD_LOSS
                            and cycle % 3)
                eligible = plane.arrived > plane.admitted()
                t0 = time.perf_counter()
                delta = plane.step(spec.now, full_solve=full)
                wall_ms = (time.perf_counter() - t0) * 1000
                if eligible and delta == 0:
                    res.unavailable_cycles += 1
                    res.unavailable_wall_ms += wall_ms
                res.max_degradation_level = max(
                    res.max_degradation_level, ctl.max_level())

            for cycle in range(spec.storm_cycles):
                cycle_once(cycle, inject=True)
            self._heal(plane, farm, mesh_inj)

            # recovery: no new faults; cooldown probes + normal
            # admission must converge on the twin within the bound
            level_trace = [ctl.max_level()]
            for r in range(1, spec.convergence_bound + 1):
                cycle_once(spec.storm_cycles + r - 1, inject=False)
                level_trace.append(ctl.max_level())
                if (ctl.max_level() == 0
                        and canonical_dump(plane.store) == twin_dump):
                    res.converged = True
                    res.convergence_cycles = r
                    break
            res.recovered_identical = (
                canonical_dump(plane.store) == twin_dump)
            res.levels_zero = ctl.max_level() == 0
            res.monotone_recovery = all(
                b <= a for a, b in zip(level_trace, level_trace[1:]))
            res.invariant_violations = len(
                InvariantAuditor(plane.store).audit())
            res.transitions = {
                s: len(ctl.transitions_for(s))
                for s in resilience.SUBSYSTEMS
                if ctl.transitions_for(s)}
            cycles_total = spec.storm_cycles + (
                res.convergence_cycles if res.converged
                else spec.convergence_bound)
            eligible_cycles = max(1, cycles_total)
            res.availability = 1.0 - res.unavailable_cycles / eligible_cycles
            if plane.manager is not None:
                res.durable_identical = self._durable_check(plane)
        return res

    def _durable_check(self, plane: _Plane) -> bool:
        """kill-storm's extra oracle: close the durable plane, recover
        a fresh store from disk, and demand byte identity with the
        live one — the storm (failed fsyncs, a died checkpoint) must
        not have cost a single acknowledged record."""
        from kueue_oss_tpu_torch.persist.manager import PersistenceManager

        live = canonical_dump(plane.store)
        plane.manager.close()
        m2 = PersistenceManager(self.spec.persistence_dir)
        try:
            recovered = m2.recover()
            return canonical_dump(recovered.store) == live
        finally:
            m2.close()


def run_campaign(profile: str, seed: int = 0, **kw) -> CampaignResult:
    """Convenience wrapper: build, run, return the result."""
    return ChaosCampaign(CampaignSpec(profile=profile, seed=seed,
                                      **kw)).run()
