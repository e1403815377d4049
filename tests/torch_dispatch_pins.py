"""The MultiKueue dispatch and TAS controller runs of chip_smoke.py's
phase 20, for either package.

Phase 20 drives the what-if-scored dispatch and the TAS controllers:

- (a) bench.py's phase-2 fleet (bench.py:1851-1990): a hub over four
  workers (``tight-a/b/c``, ``roomy``), six candidate sizes, each
  dispatched by ``WhatIfDispatcher(check_oracle=True)`` and by
  ``IncrementalDispatcher``; time to admit in simulated seconds;
- (b) pricing at fleet scale: 8 worker clusters, each holding a
  contended, all-pending lean backlog of Kueue's large-scale mix
  (``GeneratorConfig.large_scale(preemption=False)``: 35 / 11 / 4
  small / medium / large per ClusterQueue), four at 1 cohort x 10
  ClusterQueues and four at 2 x 5, quotas scaled 0.5-2x; one
  nomination priced with ``check_oracle=True``;
- (c) node-failure recovery on phase 14's mixed TAS store after a
  host-only ``run_until_quiet``: a seeded ``NodeFlapInjector`` flap and
  ``NodeFailureController`` past the grace period and the recovery
  timeout, TASDeviceFillCounts on;
- (d) the delayed TAS path: the TAS drain store cut to its first 1,500
  workloads with an admission check on every ClusterQueue, the checks
  set Ready, ``WorkloadReconciler`` queueing the scheduler's second
  pass, TASDeviceFillCounts on;
- (e) ``simulate_trace`` with two down flaps and one up flap on a
  generated lean trace whose store carries the 640 TAS nodes.

Every function here takes the package name (``JAX`` or ``PORT``) and, on
the port, the device; tests/test_torch_dispatch.py,
tests/test_torch_failure_recovery.py and
tests/test_torch_workload_controller.py run both packages through them,
and chip_smoke.py keeps its own copies (port types only), held to
these by the tests. Generated workloads draw their uids from a counter
of the process, so these functions renumber them.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_dispatch_pins.py``,
it prints the JAX package's records in the form chip_smoke.py pins them.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_scheduler_pins import committed_store_digest  # noqa: E402

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"

#: (a): bench.py's round timeout and candidate sizes (bench.py:1946-1947)
ROUND_TIMEOUT = 15.0
BENCH_SIZES = (300, 3000, 1000, 300, 2500, 1500)
#: (b): per worker (name, cohorts, ClusterQueues per cohort, quota
#: scale, fill) and the candidate's cpu; its LocalQueue exists on every
#: worker. ``fill`` None keeps the whole generated backlog (the worker
#: saturates); a fraction keeps the arrival-ordered prefix whose cpu
#: stays within that share of the worker's nominal quota (headroom)
FLEET = (("w0", 1, 10, 0.5, None), ("w1", 2, 5, 0.75, None),
         ("w2", 1, 10, 1.0, None), ("w3", 2, 5, 1.25, None),
         ("w4", 1, 10, 1.5, 0.9), ("w5", 2, 5, 1.75, 0.6),
         ("w6", 1, 10, 2.0, 0.75), ("w7", 2, 5, 0.5, None))
FLEET_CPU = 5
FLEET_NOW = 10.0
#: (c): the flap's seed and size, and the controller's clock
FLAP_SEED = 36
FLAP_COUNT = 96
FAILURE_TIMES = (200.0, 231.0, 600.0)
#: (d): the TAS drain store's depth (phase 4's cut)
DELAYED_WORKLOADS = 1500
#: (e): the trace's flaps (virtual ms) and the scenario's seed
TRACE_FLAPS = ((40.0, True, 3), (90.0, True, 2), (400.0, False, 0))
TRACE_SEED = 3


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _types(root: str):
    return mod(root, "api.types")


def _device_kw(root: str, device: str) -> dict:
    return {} if root == JAX else {"device": device}


# ---------------------------------------------------------------------------
# (a) bench.py's phase-2 fleet
# ---------------------------------------------------------------------------


def bench_worker(root: str, name: str, quota: int, background_cpu=(),
                 device: str = "cpu"):
    """bench.py's ``worker_env`` (bench.py:1852-1868)."""
    T = _types(root)
    env = mod(root, "multikueue").WorkerEnvironment(
        name, **_device_kw(root, device))
    store = env.store
    store.upsert_resource_flavor(T.ResourceFlavor(name="f0"))
    store.upsert_cluster_queue(T.ClusterQueue(
        name="wcq", preemption=T.PreemptionPolicy(),
        resource_groups=[T.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[T.FlavorQuotas(name="f0", resources=[
                T.ResourceQuota(name="cpu", nominal=quota)])])]))
    store.upsert_local_queue(T.LocalQueue(name="lq", cluster_queue="wcq"))
    for i, cpu in enumerate(background_cpu):
        store.add_workload(T.Workload(
            name=f"bg{i}", queue_name="lq", creation_time=float(i),
            uid=i + 1, podsets=[T.PodSet(count=1, requests={"cpu": cpu})]))
    env.run_cycle(5.0)
    return env


def bench_workers(root: str, device: str = "cpu") -> list:
    return [bench_worker(root, "tight-a", 2000, (1500,), device),
            bench_worker(root, "tight-b", 2500, (2000,), device),
            bench_worker(root, "tight-c", 2000, (1600,), device),
            bench_worker(root, "roomy", 8000, (1000,), device)]


class Hub:
    """bench.py's hub (bench.py:1878-1933): one ClusterQueue with the
    MultiKueue admission check, a host scheduler, the workload
    reconciler and the MultiKueue controller over the workers."""

    def __init__(self, root: str, workers, dispatcher,
                 device: str = "cpu") -> None:
        T = _types(root)
        mk = mod(root, "multikueue")
        self.store = mod(root, "core.store").Store()
        self.store.upsert_resource_flavor(T.ResourceFlavor(name="f0"))
        self.store.upsert_cluster_queue(T.ClusterQueue(
            name="hubcq", admission_checks=["multikueue"],
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f0", resources=[
                    T.ResourceQuota(name="cpu", nominal=16000)])])]))
        self.store.upsert_local_queue(T.LocalQueue(
            name="lq", cluster_queue="hubcq"))
        self.store.upsert_admission_check(T.AdmissionCheck(
            name="multikueue",
            controller_name=mk.MULTIKUEUE_CONTROLLER_NAME))
        self.queues = mod(root, "core.queue_manager").QueueManager(
            self.store)
        self.scheduler = mod(root, "scheduler.scheduler").Scheduler(
            self.store, self.queues, **_device_kw(root, device))
        self.wr = mod(root, "controllers").WorkloadReconciler(
            self.store, self.scheduler)
        self.clusters = [mk.MultiKueueCluster(name=e.name, environment=e)
                         for e in workers]
        self.dispatcher = dispatcher
        self.mk = mk.MultiKueueController(
            self.store, self.scheduler, self.clusters,
            dispatcher=dispatcher)
        self.t = 10.0
        self.T = T

    def submit(self, cpu: int, uid: int = 1000) -> None:
        self.t += 1.0
        self.store.add_workload(self.T.Workload(
            name="wl", queue_name="lq", creation_time=self.t, uid=uid,
            podsets=[self.T.PodSet(count=1, requests={"cpu": cpu})]))

    def tick(self) -> None:
        self.t += 1.0
        self.scheduler.schedule(self.t)
        self.mk.reconcile_all(self.t)
        for c in self.clusters:
            if c.active:
                c.environment.run_cycle(self.t)
        self.mk.reconcile_all(self.t)
        self.wr.reconcile_all(self.t)


def whatif_dispatcher(root: str, device: str = "cpu"):
    return mod(root, "multikueue").WhatIfDispatcher(
        round_timeout_s=ROUND_TIMEOUT, check_oracle=True,
        **_device_kw(root, device))


def incremental_dispatcher(root: str):
    return mod(root, "multikueue").IncrementalDispatcher(
        round_timeout_s=ROUND_TIMEOUT)


def dispatch_once(root: str, dispatcher, cpu: int, device: str = "cpu"):
    """bench.py's ``dispatch_once``: (time to admit in simulated s, the
    hub, the winner per tick until Ready)."""
    hub = Hub(root, bench_workers(root, device), dispatcher, device)
    hub.submit(cpu)
    t_submit = hub.t
    for _ in range(60):
        hub.tick()
        wl = hub.store.workloads["default/wl"]
        st = wl.status.admission_checks.get("multikueue")
        if st is not None and st.state == "Ready":
            return hub.t - t_submit, hub
    raise RuntimeError(f"dispatch never admitted (cpu={cpu})")


def report_record(report) -> dict:
    """The fields of a DispatchReport both packages compute."""
    return {"best": report.best,
            "scores": [[s.cluster, s.admitted, s.admit_round,
                        s.util_fraction] for s in report.scores],
            "unpriceable": dict(sorted(report.unpriceable.items())),
            "batch_width": report.batch_width,
            "oracle_best": report.oracle_best,
            "oracle_identical": report.oracle_identical}


def bench_fleet(root: str, device: str = "cpu") -> dict:
    """Leg (a): each size by both dispatchers. Records the times to
    admit, the winner, and each WhatIf pricing's report record."""
    out = {"whatif": [], "incremental": [], "winners": {"whatif": [],
                                                         "incremental": []},
           "reports": [], "agree": 0, "scored": 0}
    for label in ("whatif", "incremental"):
        for cpu in BENCH_SIZES:
            disp = (whatif_dispatcher(root, device) if label == "whatif"
                    else incremental_dispatcher(root))
            tta, hub = dispatch_once(root, disp, cpu, device)
            out[label].append(tta)
            out["winners"][label].append(
                hub.store.workloads["default/wl"].status.cluster_name)
            if label == "whatif":
                rep = disp.last_reports.get("default/wl")
                if rep is not None:
                    out["scored"] += 1
                    out["reports"].append(report_record(rep))
                    if rep.best == rep.oracle_best and rep.oracle_identical:
                        out["agree"] += 1
    return out


# ---------------------------------------------------------------------------
# (b) pricing at fleet scale
# ---------------------------------------------------------------------------


def fleet_backlog(schedule, quota: int, fill) -> list:
    """The generated workloads a worker holds pending: all of them, or
    (``fill`` a fraction) the arrival-ordered prefix whose cpu stays
    within ``fill * quota``."""
    if fill is None:
        return [g.workload for g in schedule]
    out, cpu = [], 0
    for g in schedule:
        need = sum(ps.count * ps.requests["cpu"]
                   for ps in g.workload.podsets)
        if cpu + need > fill * quota:
            break
        out.append(g.workload)
        cpu += need
    return out


def fleet_worker(root: str, name: str, n_cohorts: int, cqs: int,
                 scale: float, fill=None, device: str = "cpu"):
    """One worker of leg (b): Kueue's large-scale generator config
    without preemption at ``n_cohorts`` x ``cqs``, its quota scaled by
    ``scale``, its ``fleet_backlog`` added pending (uids 1..n in
    arrival order)."""
    gen = mod(root, "perf.generator")
    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs
    cfg.nominal_quota = int(round(cfg.nominal_quota * scale))
    store, schedule = gen.generate(cfg)
    env = mod(root, "multikueue").WorkerEnvironment(
        name, store=store, **_device_kw(root, device))
    quota = cfg.nominal_quota * n_cohorts * cqs
    for i, wl in enumerate(fleet_backlog(schedule, quota, fill)):
        wl.uid = i + 1
        store.add_workload(wl)
    return env


def fleet_envs(root: str, device: str = "cpu", cqs_cut: int = 0) -> dict:
    """Leg (b)'s workers by name; ``cqs_cut`` > 0 keeps that many
    ClusterQueues per worker (the tests' small size)."""
    out = {}
    for name, n_cohorts, cqs, scale, fill in FLEET:
        if cqs_cut:
            n_cohorts, cqs = (1, cqs_cut) if n_cohorts == 1 else (
                2, max(1, cqs_cut // 2))
        out[name] = fleet_worker(root, name, n_cohorts, cqs, scale, fill,
                                 device)
    return out


def fleet_candidate(root: str):
    T = _types(root)
    return T.Workload(name="cand", queue_name="lq-cq-0-0", uid=99999,
                      creation_time=FLEET_NOW, priority=100,
                      podsets=[T.PodSet(count=1,
                                        requests={"cpu": FLEET_CPU})])


def price_fleet(root: str, envs: dict, device: str = "cpu"):
    wl = fleet_candidate(root)
    price = mod(root, "sim.dispatch").price_dispatch
    kw = _device_kw(root, device)
    return price(wl, envs, now=FLEET_NOW, check_oracle=True, **kw)


# ---------------------------------------------------------------------------
# (c) node-failure recovery on the mixed TAS store
# ---------------------------------------------------------------------------


def tas_host_store(root: str, device: str = "cpu"):
    """Phase 14's run (d): the mixed TAS store through a host-only
    ``run_until_quiet(now=100.0, tick=0.001)``. Returns (store,
    scheduler)."""
    from kueue_oss_tpu_torch.scenarios import tas_mixed_store

    T = _types(root)
    store = tas_mixed_store(T, mod(root, "core.store").Store)
    sched = mod(root, "scheduler.scheduler").Scheduler(
        store, mod(root, "core.queue_manager").QueueManager(store),
        **_device_kw(root, device))
    sched.run_until_quiet(now=100.0, tick=0.001)
    return store, sched


def assignments_digest(store, keys) -> str:
    """sha256 over each key's topology assignments (levels, domains)."""
    rows = []
    for key in keys:
        adm = store.workloads[key].status.admission
        rows.append([key, None if adm is None else [
            [psa.name, None if psa.topology_assignment is None else
             [list(psa.topology_assignment.levels),
              [[list(d.values), d.count]
               for d in psa.topology_assignment.domains]]]
            for psa in adm.podset_assignments]])
    return hashlib.sha256(json.dumps(
        rows, separators=(",", ":")).encode()).hexdigest()


def node_failure_leg(root: str, store, sched, seed: int = FLAP_SEED,
                     count: int = FLAP_COUNT,
                     times=FAILURE_TIMES) -> dict:
    """Leg (c): flap ``count`` seeded nodes down, then reconcile the
    failure controller at ``times`` (clock start, past the grace
    period, past the recovery timeout) with TASDeviceFillCounts on.
    Records the failed nodes, the workloads on them by how many failed
    nodes they used, the replaced and evicted keys, the replaced
    workloads' new assignments and the committed-store digest."""
    features = mod(root, "features")
    nfc = mod(root, "controllers").NodeFailureController(
        store, sched, grace_period_s=30.0, recovery_timeout_s=300.0)
    injector = mod(root, "chaos").NodeFlapInjector(store, seed=seed)
    before = {k: assignments_digest(store, [k])
              for k, w in store.workloads.items() if w.is_quota_reserved}
    down = injector.flap_down(count=count)
    hit = {}
    for key in before:
        n = len(nfc._assigned_nodes(store.workloads[key]) & set(down))
        if n:
            hit[key] = n
    features.set_gates({"TASDeviceFillCounts": True})
    try:
        for t in times:
            nfc.reconcile(t)
    finally:
        features.set_gates({"TASDeviceFillCounts": False})
    evicted = sorted(k for k in hit if store.workloads[k].is_evicted)
    replaced = sorted(
        k for k in hit if not store.workloads[k].is_evicted
        and assignments_digest(store, [k]) != before[k])
    return {"down": sorted(down),
            "single": sorted(k for k, n in hit.items() if n == 1),
            "multi": sorted(k for k, n in hit.items() if n > 1),
            "replaced": replaced, "evicted": evicted,
            "assignments": assignments_digest(store, replaced),
            "digest": committed_store_digest(store)}


# ---------------------------------------------------------------------------
# (d) the delayed TAS path
# ---------------------------------------------------------------------------


def delayed_tas_store(root: str, n_workloads: int = DELAYED_WORKLOADS):
    """The TAS drain store cut to its first ``n_workloads`` with the
    admission check ``prov`` on every ClusterQueue (all of them use
    the TAS flavor)."""
    from kueue_oss_tpu_torch.scenarios import tas_drain_store

    T = _types(root)
    store = tas_drain_store(T, mod(root, "core.store").Store,
                            n_workloads=n_workloads)
    store.upsert_admission_check(T.AdmissionCheck(
        name="prov", controller_name="example.com/provisioning"))
    for cq in list(store.cluster_queues.values()):
        cq.admission_checks = ["prov"]
        store.upsert_cluster_queue(cq)
    return store


def delayed_tas_leg(root: str, store, device: str = "cpu",
                    ticks: int = 6) -> dict:
    """Leg (d): a host ``run_until_quiet(now=100.0)`` reserves quota with
    the topology Pending; then per tick every reserved workload's check
    is set Ready, the reconciler queues the second pass, and a host
    cycle runs it; a last reconcile admits. TASDeviceFillCounts on."""
    features = mod(root, "features")
    sched = mod(root, "scheduler.scheduler").Scheduler(
        store, mod(root, "core.queue_manager").QueueManager(store),
        **_device_kw(root, device))
    wr = mod(root, "controllers").WorkloadReconciler(store, sched)
    features.set_gates({"TASDeviceFillCounts": True})
    try:
        sched.run_until_quiet(now=100.0, tick=0.001)
        reserved = sorted(k for k, w in store.workloads.items()
                          if w.is_quota_reserved)
        pending_topology = sum(
            1 for k in reserved for psa in
            store.workloads[k].status.admission.podset_assignments
            if psa.delayed_topology_request == "Pending")
        now = 200.0
        for _ in range(ticks):
            for k in reserved:
                for st in store.workloads[k].status.admission_checks.values():
                    st.state = "Ready"
            wr.reconcile_all(now)
            now += 1.0
            sched.schedule(now)
        wr.reconcile_all(now)
    finally:
        features.set_gates({"TASDeviceFillCounts": False})
    admitted = sorted(k for k, w in store.workloads.items()
                      if w.is_admitted)
    return {"reserved": len(reserved), "pending_topology": pending_topology,
            "admitted": len(admitted),
            "placed": sum(1 for k in reserved for psa in
                          store.workloads[k].status.admission
                          .podset_assignments
                          if psa.delayed_topology_request == "Ready"),
            "digest": committed_store_digest(store)}


# ---------------------------------------------------------------------------
# (e) simulate_trace with node flaps
# ---------------------------------------------------------------------------


def flap_trace(root: str):
    """A generated lean trace (Kueue's large-scale mix at 2 cohorts x 3
    ClusterQueues without preemption, uids 1..n in arrival order) whose
    store carries the TAS drain store's 640 nodes, and its spec."""
    from kueue_oss_tpu_torch.scenarios import BLOCK, RACK

    T = _types(root)
    gen = mod(root, "perf.generator")
    sim = mod(root, "sim")
    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = 2, 3
    store, schedule = gen.generate(cfg)
    for i, g in enumerate(schedule):
        g.workload.uid = i + 1
    for r in range(10):
        for h in range(64):
            store.upsert_node(T.Node(
                name=f"n-{r}-{h}", labels={BLOCK: "b0", RACK: f"r{r}"},
                allocatable={"cpu": 96}))
    spec = sim.ScenarioSpec(
        name="flappy", arrival_scale=2.0, seed=TRACE_SEED,
        node_flaps=[sim.FlapEvent(at_ms=at, down=down, count=n)
                    for at, down, n in TRACE_FLAPS])
    return store, schedule, spec


def flap_trace_leg(root: str, device: str = "cpu") -> dict:
    store, schedule, spec = flap_trace(root)
    out = mod(root, "sim").simulate_trace(
        store, schedule, spec, **_device_kw(root, device))
    return {k: out[k] for k in ("workloads", "admitted", "finished",
                                "preemptions", "cycles", "sim_wall_ms",
                                "tta_ms_by_class", "node_flaps")}


# ---------------------------------------------------------------------------
# the JAX package's records
# ---------------------------------------------------------------------------


def reference_pins() -> dict:
    out = {"bench_fleet": bench_fleet(JAX)}
    out["fleet"] = report_record(price_fleet(JAX, fleet_envs(JAX)))
    store, sched = tas_host_store(JAX)
    out["node_failure"] = node_failure_leg(JAX, store, sched)
    out["delayed_tas"] = delayed_tas_leg(JAX, delayed_tas_store(JAX))
    out["flap_trace"] = flap_trace_leg(JAX)
    return out


if __name__ == "__main__":
    import time

    t0 = time.monotonic()
    pins = {}
    for name, fn in (
            ("bench_fleet", lambda: bench_fleet(JAX)),
            ("fleet", lambda: report_record(price_fleet(JAX,
                                                        fleet_envs(JAX)))),
            ("node_failure", lambda: node_failure_leg(
                JAX, *tas_host_store(JAX))),
            ("delayed_tas", lambda: delayed_tas_leg(
                JAX, delayed_tas_store(JAX))),
            ("flap_trace", lambda: flap_trace_leg(JAX))):
        pins[name] = fn()
        print(f"{name} ({time.monotonic() - t0:.1f} s) "
              + json.dumps(pins[name]), file=sys.stderr, flush=True)
    print(json.dumps(pins, indent=1))
