"""The port stands alone: no module of kueue_oss_tpu_torch/ and not
chip_smoke.py imports jax, jaxlib or the JAX package (the relaxed arm's
solver/relax.py and solver/cuda_relax.py included; its kernel source
names neither), and the port imports and drains (lean, FULL, fair
sharing and admission fair sharing, and lean through the relaxed arm),
schedules, streams, runs the perf simulator, a what-if sweep, the relax
tier, a resident FULL sweep, a MultiKueue hub with the what-if-scored
dispatcher, the node-failure controller, and drains through the solver
sidecar (a clean one and a chaos one) and a solver farm loaded from a
Configuration, records its decisions, ledger rows, metrics and spans,
and runs the chaos campaigns over the degradation ladder and the
durable control plane (a kill-storm recovered from its WAL and
checkpoints, a solver storm), with those modules blocked."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "kueue_oss_tpu"}


def _sources():
    # _build/ holds generated kernel builds (gitignored), not sources
    files = sorted(p for p in (ROOT / "kueue_oss_tpu_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    assert "kueue_oss_tpu_torch/solver/engine.py" in names
    assert "kueue_oss_tpu_torch/solver/full_kernels.py" in names
    assert "kueue_oss_tpu_torch/core/eviction.py" in names
    assert "kueue_oss_tpu_torch/solver/fair_kernels.py" in names
    assert "kueue_oss_tpu_torch/core/afs.py" in names
    assert "kueue_oss_tpu_torch/native/__init__.py" in names
    assert "kueue_oss_tpu_torch/scheduler/scheduler.py" in names
    assert "kueue_oss_tpu_torch/tas/snapshot.py" in names
    assert "kueue_oss_tpu_torch/scheduler/streaming.py" in names
    assert "kueue_oss_tpu_torch/config/configuration.py" in names
    assert "kueue_oss_tpu_torch/config/__init__.py" in names
    assert "kueue_oss_tpu_torch/util/primitives.py" in names
    for name in ("perf/__init__.py", "perf/generator.py", "perf/runner.py",
                 "perf/checker.py", "sim/__init__.py", "sim/scenario.py",
                 "sim/batch.py", "sim/report.py", "sim/engine.py",
                 "sim/resident.py", "sim/traces.py",
                 "solver/relax.py", "solver/cuda_relax.py",
                 "sim/dispatch.py", "multikueue/__init__.py",
                 "multikueue/cluster.py", "multikueue/dispatcher.py",
                 "multikueue/controller.py", "controllers/__init__.py",
                 "controllers/workload_controller.py",
                 "controllers/failure_recovery.py", "chaos/__init__.py",
                 "solver/service.py", "solver/resilience.py",
                 "solver/meshutil.py", "solver/sharded.py",
                 "federation/__init__.py",
                 "federation/farm.py", "federation/fleet.py",
                 "util/tlsconfig.py", "entry.py", "smoke_kernel.py",
                 "metrics/__init__.py", "debugger/__init__.py",
                 "debugger/profiling.py", "obs/__init__.py",
                 "obs/ledger.py", "obs/health.py", "obs/devtel.py",
                 "sim/replay.py", "util/fsutil.py",
                 "resilience/__init__.py", "persist/__init__.py",
                 "persist/codec.py", "persist/hooks.py", "persist/wal.py",
                 "persist/checkpoint.py", "persist/manager.py",
                 "persist/auditor.py", "persist/shipping.py",
                 "persist/crashtest.py", "chaos/campaign.py"):
        assert f"kueue_oss_tpu_torch/{name}" in names, name
    assert "chip_smoke.py" in names
    # the exact-name comparison lets the port's own name through
    assert "kueue_oss_tpu_torch" not in FORBIDDEN


def test_kernel_sources_name_no_jax():
    """The CUDA sources (the relaxed LP's among them) include CUDA headers
    and their own, nothing of JAX or XLA."""
    sources = sorted((ROOT / "kueue_oss_tpu_torch" / "csrc").glob("*.cu*"))
    assert "relax_lp.cu" in {p.name for p in sources}
    for path in sources:
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                assert "jax" not in line.lower() and "xla" not in line.lower()


def test_port_drains_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "kueue_oss_tpu"):
            sys.modules[name] = None  # any import of them now fails
        from kueue_oss_tpu_torch.api import types
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.scenarios import tas_drain_store
        from kueue_oss_tpu_torch.solver.engine import SolverEngine
        import chip_smoke  # noqa: F401

        store = tas_drain_store(types, Store, n_racks=2, n_hosts=4,
                                n_cohorts=1, n_cqs=2, n_workloads=40)
        result = SolverEngine(store, QueueManager(store),
                              device="cpu").drain()
        assert result.admitted > 0, result
        # and the FULL drain (preemption), through its eviction path
        from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
        store, wave1, wave2 = baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        engine = SolverEngine(store, QueueManager(store), device="cpu")
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            full = engine.drain()
        assert full.evicted > 0, full
        # fair sharing and admission fair sharing
        from kueue_oss_tpu_torch.core.afs import AfsManager
        from kueue_oss_tpu_torch.scenarios import (
            afs_baseline_store, fair_reclaim_store)
        store, wave1, wave2 = fair_reclaim_store(
            types, Store, n_cohorts=1, scale=0.05)
        engine = SolverEngine(store, QueueManager(store), device="cpu",
                              enable_fair_sharing=True)
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            fair = engine.drain()
        assert fair.full_stats.entry_picks > 0, fair
        store, afs, backlog = afs_baseline_store(
            types, Store, AfsManager, n_cohorts=1, scale=0.05)
        for wl in backlog:
            store.add_workload(wl)
        afs_result = SolverEngine(store, QueueManager(store, afs=afs),
                                  device="cpu").drain(now=60.0)
        assert afs_result.admitted > 0, afs_result
        # the scheduler over the device drain, its oracle re-check and
        # the host cycles that mop up
        from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
        store, wave1, wave2 = baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        sched = Scheduler(store, QueueManager(store), solver="auto",
                          device="cpu", solver_min_backlog=4)
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            sched.run_until_quiet(now=100.0)
        assert sched.solver_counts["drains"] == 2, sched.solver_counts
        assert sched.last_drain.verified > 0, sched.last_drain
        # the observability layer saw it: journal, ledger, metrics, and
        # spans on a tracer with device telemetry on
        from kueue_oss_tpu_torch import metrics, obs
        from kueue_oss_tpu_torch.debugger.profiling import (
            Tracer, attach_to_scheduler)
        from kueue_oss_tpu_torch.sim.replay import kind_counts_per_cycle
        assert kind_counts_per_cycle(obs.recorder.events())
        assert obs.cycle_ledger.last_row(obs.SOLVER_DRAIN) is not None
        assert "kueue_admitted_workloads_total" in metrics.registry.render()
        obs.device_telemetry.enabled = True
        tracer = Tracer()
        attach_to_scheduler(sched, tracer)
        for wl in wave1:
            sched.finish_workload(wl.key, now=150.0)
        sched.run_until_quiet(now=200.0)
        assert "schedule" in tracer.chrome_trace()
        obs.device_telemetry.reset()
        # the host TAS placement, its fill-in counts on the device path
        from kueue_oss_tpu_torch import features
        from kueue_oss_tpu_torch.scenarios import tas_mixed_store
        features.set_gates({"TASDeviceFillCounts": True})
        store = tas_mixed_store(types, Store, n_workloads=60)
        sched = Scheduler(store, QueueManager(store), device="cpu")
        sched.run_until_quiet(now=100.0)
        features.reset()
        assert any(w.is_quota_reserved and all(
            psa.topology_assignment is not None
            for psa in w.status.admission.podset_assignments)
            for w in store.workloads.values())
        # streaming: micro-drains through the lean drain between full
        # drains, a serve loop with its watch-driven worker
        import threading
        from kueue_oss_tpu_torch.config import StreamingConfig
        from kueue_oss_tpu_torch.scenarios import (
            streaming_store, streaming_ticks)
        store = streaming_store(types, Store)
        sched = Scheduler(store, QueueManager(store), solver="auto",
                          device="cpu", solver_min_backlog=0,
                          streaming=StreamingConfig(enabled=True))
        micro = [res.micro_batch for kind, _, res in streaming_ticks(
            types, store, sched, ticks=3, per_tick=64, solve_every=2)
            if kind == "micro"]
        assert sum(micro) > 0, micro
        stop = threading.Event()
        server = threading.Thread(target=sched.serve, args=(stop,),
                                  kwargs={"poll": 0.01})
        server.start()
        stop.set()
        server.join(timeout=30)
        assert not server.is_alive()
        # the perf runner host only, and a what-if sweep on the CPU
        from kueue_oss_tpu_torch.perf import (
            GeneratorConfig, Simulator, generate)
        from kueue_oss_tpu_torch.sim import (
            WhatIfEngine, arrival_sweep, cross, quota_sweep)
        cfg = GeneratorConfig(n_cohorts=1, cqs_per_cohort=2)
        for wc in cfg.classes:
            wc.count = 5
        store, schedule = generate(cfg)
        stats = Simulator(store, schedule).run()
        assert stats.admitted == stats.finished == 30, stats.summary()
        store, schedule = generate(cfg)
        for g in schedule:
            store.add_workload(g.workload)
        report = WhatIfEngine(store, device="cpu").run(cross(
            quota_sweep((0.5, 2.0)), arrival_sweep((0.5, 1.5))))
        assert report.parity["identical"], report.parity
        assert len(report.scenarios) == 9
        # the relaxed arm: an engine drain through it, and the relax tier
        from kueue_oss_tpu_torch.sim import solve_scenarios_relax
        from kueue_oss_tpu_torch.solver import tensors
        cfg = GeneratorConfig.large_scale(preemption=False)
        cfg.n_cohorts, cfg.cqs_per_cohort = 1, 2
        for wc in cfg.classes:
            wc.count = 5
        store, schedule = generate(cfg)
        for g in schedule:
            store.add_workload(g.workload)
        engine = SolverEngine(store, QueueManager(store), device="cpu")
        engine.relax_force = True
        engine.relax_audit_every = 0
        assert engine.drain().admitted > 0
        assert engine.last_drain_arm == "relax"
        problem, _ = engine.export()
        problem = tensors.pad_workloads(problem, 64)
        tier = solve_scenarios_relax(problem, [{}, {}], device="cpu")
        assert tier.tier == ["relax", "relax"]
        # the FULL what-if sweep: a resident engine over a trace store
        from kueue_oss_tpu_torch.config import SimulatorConfig
        from kueue_oss_tpu_torch.sim import (
            load_ladder, philly_trace, store_from_trace)
        store = store_from_trace(philly_trace(24, seed=3))
        full = WhatIfEngine(store, config=SimulatorConfig(
            full_kernel=True, full_sweep_max=2), resident=True,
            device="cpu").run(cross(quota_sweep((0.5, 2.0)),
                                    arrival_sweep((1.5,))), parity=1)
        assert full.parity["identical"], full.parity
        assert [r["tier"] for r in full.scenarios] == (
            ["full"] * 2 + ["relax"] * 4)
        assert load_ladder(store, factors=(1, 2), full=True,
                           device="cpu")["ladder"]
        # the MultiKueue hub over the what-if-scored dispatcher, and the
        # node-failure controller's in-place replacement
        from kueue_oss_tpu_torch.controllers import (
            NodeFailureController, WorkloadReconciler)
        from kueue_oss_tpu_torch.multikueue import (
            MULTIKUEUE_CONTROLLER_NAME, MultiKueueCluster,
            MultiKueueController, WhatIfDispatcher, WorkerEnvironment)

        def cq(store, quota, checks=()):
            store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
            store.upsert_cluster_queue(types.ClusterQueue(
                name="cq", admission_checks=list(checks),
                resource_groups=[types.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[types.FlavorQuotas(name="f", resources=[
                        types.ResourceQuota(name="cpu",
                                            nominal=quota)])])]))
            store.upsert_local_queue(types.LocalQueue(
                name="lq", cluster_queue="cq"))

        hub = Store()
        cq(hub, 9000, checks=["mk"])
        hub.upsert_admission_check(types.AdmissionCheck(
            name="mk", controller_name=MULTIKUEUE_CONTROLLER_NAME))
        hub_sched = Scheduler(hub, QueueManager(hub), device="cpu")
        workers = []
        for name, quota in (("small", 2000), ("big", 8000)):
            env = WorkerEnvironment(name, device="cpu")
            cq(env.store, quota)
            workers.append(MultiKueueCluster(name=name, environment=env))
        disp = WhatIfDispatcher(check_oracle=True, device="cpu")
        mk = MultiKueueController(hub, hub_sched, workers,
                                  dispatcher=disp, check_name="mk")
        wr = WorkloadReconciler(hub, hub_sched)
        hub.add_workload(types.Workload(
            name="w", queue_name="lq", podsets=[types.PodSet(
                count=1, requests={"cpu": 3000})]))
        for t in (1.0, 2.0):
            hub_sched.schedule(t)
            mk.reconcile_all(t)
            for w in workers:
                w.environment.run_cycle(t)
            mk.reconcile_all(t)
            wr.reconcile_all(t)
        assert hub.workloads["default/w"].status.cluster_name == "big"
        assert hub.workloads["default/w"].is_admitted
        assert disp.faults == [] and disp.counts["scored"] == 1
        features.set_gates({"TASDeviceFillCounts": True})
        store = tas_mixed_store(types, Store, n_workloads=60)
        sched = Scheduler(store, QueueManager(store), device="cpu")
        sched.run_until_quiet(now=100.0)
        held = [w for w in store.workloads.values()
                if w.is_quota_reserved]
        nfc = NodeFailureController(store, sched)
        node = sorted(nfc._assigned_nodes(held[0]))[0]
        store.nodes[node].ready = False
        nfc.reconcile(200.0)
        nfc.reconcile(240.0)
        features.reset()
        assert node not in nfc._assigned_nodes(held[0])
        # the solver sidecar: a drain through a clean sidecar, and the
        # breaker and plan guard against a chaos one
        import os, tempfile
        from kueue_oss_tpu_torch.chaos import (
            CORRUPT_PLAN, ChaosSolverServer, FaultInjector)
        from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable
        from kueue_oss_tpu_torch.solver.service import (
            SolverClient, SolverServer)
        path = os.path.join(tempfile.mkdtemp(), "s.sock")
        srv = SolverServer(path, device="cpu")
        srv.serve_in_background()
        store, wave1, wave2 = baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        engine = SolverEngine(store, QueueManager(store), device="cpu",
                              remote=SolverClient(path))
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            remote = engine.drain(now=100.0)
        assert remote.evicted > 0 and engine.last_drain_arm == "remote"
        srv.shutdown()
        srv.server_close()
        path = os.path.join(tempfile.mkdtemp(), "c.sock")
        srv = ChaosSolverServer(path, FaultInjector(schedule=[CORRUPT_PLAN]),
                                device="cpu")
        srv.serve_in_background()
        store = tas_drain_store(types, Store, n_racks=2, n_hosts=4,
                                n_cohorts=1, n_cqs=2, n_workloads=40)
        engine = SolverEngine(store, QueueManager(store), device="cpu",
                              remote=SolverClient(path, max_retries=0))
        try:
            engine.drain()
            raise AssertionError("a corrupt plan was accepted")
        except SolverUnavailable:
            pass
        assert engine.health.consecutive_failures == 1
        assert engine.drain().admitted > 0
        srv.shutdown()
        srv.server_close()
        # a fleet member on a solver farm loaded from a Configuration,
        # with the resources section shaping its requests
        from kueue_oss_tpu_torch import config
        from kueue_oss_tpu_torch.core import workload_info
        from kueue_oss_tpu_torch.federation import (
            FarmScheduler, attach_farm, build_member)
        cfg = config.load({"federation": {"tenantWeights": {"cp-a": 2}},
                           "resources": {"quotaCheckStrategy":
                                         "IgnoreUndeclared"}})
        assert config.validate(cfg) == []
        workload_info.set_resources_config(cfg.resources)
        path = os.path.join(tempfile.mkdtemp(), "f.sock")
        srv = SolverServer(path, device="cpu")
        farm = attach_farm(srv, FarmScheduler.from_config(cfg.federation))
        srv.serve_in_background()
        store, wave1, _ = baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        member = build_member("cp-a", socket_path=path, store=store,
                              device="cpu")
        for wl in wave1:
            store.add_workload(wl)
        assert member.drain(now=100.0).admitted > 0
        assert farm.served == {"cp-a": 1}
        srv.shutdown()
        srv.server_close()
        workload_info.set_resources_config(None)
        # the chaos campaigns over the degradation ladder and the
        # durable control plane
        from kueue_oss_tpu_torch.chaos import run_campaign
        res = run_campaign("kill-storm", seed=1, device="cpu",
                           persistence_dir=tempfile.mkdtemp())
        assert res.ok and res.durable_identical, res.to_dict()
        res = run_campaign("solver-storm", seed=1, device="cpu")
        assert res.ok and res.transitions.get("solver"), res.to_dict()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "kueue_oss_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("admitted", result.admitted)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "admitted" in proc.stdout
