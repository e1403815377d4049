"""The port's degradation ladder (kueue_oss_tpu_torch/resilience) and the
fault responses that report into it, against the JAX package's.

- The engine's ``device_error`` rung: a local solve that raises, on the
  lean and on the FULL drain, gives ``SolverUnavailable``, one
  ``solver_fallback_total{device_error}``, the solver ladder's host rung
  and a ``SOLVER_FALLBACK`` event, and the next successful drain clears
  it, in both packages on the same seeded backlog.
- ``DegradationController`` parity under one injected clock: the same
  seeded report and probe sequence gives equal levels, rungs,
  conditions, ``snapshot()``, transitions and history bounds.
- The breaker's single half-open probe, the relaxed arm's demotion and
  re-probe, the streaming fences and the farm's backpressure, each
  driven the same way in both packages, leave the same ladder history.
- ``obs/devtel.py`` and the breaker share the ladder's one
  ``CooldownPolicy``.

The tolerance is exact equality throughout. The JAX engines run with
``mesh_mode="off"`` (the port has no mesh arm) at the few-workload
shapes below, so each kernel compiles once per shape.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import copy

import numpy as np
import pytest

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu import obs as jax_obs
from kueue_oss_tpu import resilience as jax_res
from kueue_oss_tpu_torch import metrics as port_metrics
from kueue_oss_tpu_torch import obs as port_obs
from kueue_oss_tpu_torch import resilience as port_res


@pytest.fixture(autouse=True)
def _fresh_slo_engines():
    """The drains here feed each package's process-wide SLO engine with
    their waits; reset both after each test, so no burn-rate alert they
    raised reaches a later test's health rollup on the same worker."""
    yield
    jax_obs.slo_engine.reset()
    port_obs.slo_engine.reset()


def _mods(pkg):
    """(api types, Store, QueueManager, Scheduler, SolverEngine,
    SolverUnavailable, resilience, metrics, obs) of one package."""
    if pkg == "jax":
        from kueue_oss_tpu.api import types
        from kueue_oss_tpu.core.queue_manager import QueueManager
        from kueue_oss_tpu.core.store import Store
        from kueue_oss_tpu.scheduler.scheduler import Scheduler
        from kueue_oss_tpu.solver.engine import SolverEngine
        from kueue_oss_tpu.solver.resilience import SolverUnavailable
        return (types, Store, QueueManager, Scheduler, SolverEngine,
                SolverUnavailable, jax_res, jax_metrics, jax_obs)
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable
    return (types, Store, QueueManager, Scheduler, SolverEngine,
            SolverUnavailable, port_res, port_metrics, port_obs)


def _engine(pkg, store, **kw):
    (_, _, QueueManager, Scheduler, SolverEngine, *_rest) = _mods(pkg)
    queues = QueueManager(store)
    extra = {"mesh_mode": "off"} if pkg == "jax" else {"device": "cpu"}
    sched = Scheduler(store, queues, **(
        {} if pkg == "jax" else {"device": "cpu"}))
    engine = SolverEngine(store, queues, scheduler=sched, **extra, **kw)
    engine.relax_enabled = False
    return engine


def _lean_store(pkg, seed: int = 7):
    """Two one-flavor ClusterQueues without preemption and a seeded
    backlog (sizes from numpy): the lean drain."""
    types, Store = _mods(pkg)[:2]
    rng = np.random.default_rng(seed)
    store = Store()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(2):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"], flavors=[types.FlavorQuotas(
                    name="f", resources=[types.ResourceQuota(
                        name="cpu", nominal=40)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    for j, cpu in enumerate(rng.integers(1, 9, size=24)):
        store.add_workload(types.Workload(
            name=f"w{j}", queue_name=f"lq{j % 2}", uid=j + 1,
            creation_time=float(j), podsets=[types.PodSet(
                name="main", count=1, requests={"cpu": int(cpu)})]))
    return store


def _full_store(pkg):
    """The baseline preemption storm at a twentieth of a cohort: the
    FULL drain."""
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store

    types, Store = _mods(pkg)[:2]
    store, wave1, _ = baseline_preempt_store(
        types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    for wl in wave1:
        store.add_workload(wl)
    return store


def _history(ctl):
    return [dict(e) for e in ctl.history]


def _device_error_record(pkg, kind):
    (_, _, _, _, _, SolverUnavailable, res, metrics, obs) = _mods(pkg)
    ctl = res.DegradationController(clock=lambda: 0.0)
    with res.use(ctl):
        store = _lean_store(pkg) if kind == "lean" else _full_store(pkg)
        engine = _engine(pkg, store)
        arms = []

        def hook(arm):
            arms.append(arm)
            raise RuntimeError(f"injected device loss ({arm} arm)")

        engine.solve_fault_hook = hook
        before = metrics.solver_fallback_total.value("device_error")
        with pytest.raises(SolverUnavailable) as info:
            engine.drain(now=10.0)
        faulted = {
            "error": str(info.value),
            "cause": type(info.value.__cause__).__name__,
            "arms": list(arms),
            "device_error": (metrics.solver_fallback_total.value(
                "device_error") - before),
            "level": ctl.level(res.SOLVER), "rung": ctl.rung(res.SOLVER),
            "conditions": ctl.conditions(res.SOLVER),
            "event": [(e.kind, e.reason_slug, e.path)
                      for e in obs.recorder.events()
                      if e.reason_slug == "device_error"][-1:],
            "admitted": sum(1 for w in store.workloads.values()
                            if w.is_quota_reserved),
        }
        engine.solve_fault_hook = None
        result = engine.drain(now=20.0)
        healed = {"admitted": result.admitted,
                  "level": ctl.level(res.SOLVER),
                  "device_error": (metrics.solver_fallback_total.value(
                      "device_error") - before),
                  "history": _history(ctl)}
    return faulted, healed


@pytest.mark.parametrize("kind", ["lean", "full"])
def test_local_solve_fault_is_the_device_error_rung(kind):
    """A local solve that raises degrades the round to host cycles
    through SolverUnavailable (counted, reported, journaled) in both
    packages, and the next successful drain clears the rung."""
    jax_faulted, jax_healed = _device_error_record("jax", kind)
    port_faulted, port_healed = _device_error_record("port", kind)
    assert port_faulted["device_error"] == 1
    assert port_faulted["level"] == 3
    assert port_faulted["rung"] == "host"
    assert "device_error" in port_faulted["conditions"]
    assert port_faulted["event"] == [("solver-fallback", "device_error",
                                      "solver")]
    assert port_faulted["cause"] == "RuntimeError"
    assert port_faulted["admitted"] == 0
    assert port_healed["level"] == 0 and port_healed["admitted"] > 0
    assert port_faulted == jax_faulted
    assert port_healed == jax_healed


def _drive(res, seed: int, limit: int):
    """A seeded sequence of reports and probes against one controller
    under an injected clock; returns what every read gives after each
    step."""
    now = [0.0]
    ctl = res.DegradationController(clock=lambda: now[0],
                                    history_limit=limit)
    rng = np.random.default_rng(seed)
    pairs = [(s, c) for s in res.SUBSYSTEMS for c in res.SEVERITY[s]]
    trace = []
    for step in range(160):
        now[0] += float(rng.integers(0, 40))
        s, c = pairs[int(rng.integers(len(pairs)))]
        op = int(rng.integers(4))
        if op < 2:
            changed = ctl.report(s, c, bool(op == 0),
                                 reason=f"r{step}" if rng.random() < 0.5
                                 else "", cycle=step)
        elif op == 2:
            changed = ctl.begin_probe(s, c, float(rng.integers(0, 90)))
        else:
            ctl.end_probe(s, c, bool(rng.random() < 0.5))
            changed = None
        trace.append((changed, ctl.levels(), ctl.max_level(),
                      {x: ctl.rung(x) for x in res.SUBSYSTEMS},
                      {x: ctl.conditions(x) for x in res.SUBSYSTEMS},
                      ctl.snapshot(),
                      ctl.cooldowns.stamp((s, c)),
                      ctl.cooldowns.probing((s, c))))
    return trace, _history(ctl), {
        x: [dict(e) for e in ctl.transitions_for(x)]
        for x in res.SUBSYSTEMS}


@pytest.mark.parametrize("seed", [0, 42])
def test_controller_parity_under_one_clock(seed):
    """The same reports, probes and clock give the same ladder, history
    bounds included (a limit of 16 over 160 steps)."""
    assert port_res.LADDERS == jax_res.LADDERS
    assert port_res.SEVERITY == jax_res.SEVERITY
    assert port_res.SUBSYSTEMS == jax_res.SUBSYSTEMS
    port = _drive(port_res, seed, 16)
    jax = _drive(jax_res, seed, 16)
    assert len(port[1]) == 16
    assert port == jax
    with pytest.raises(KeyError):
        port_res.DegradationController().report("solver", "nope", True)


def test_transitions_feed_the_series_journal_and_ledger():
    """A transition sets the degradation gauge, counts the transition
    and lands as a DEGRADATION event and a DEGRADATION_ROW ledger row,
    as in the JAX package; with the controller disabled only the state
    and the series move."""
    out = {}
    for name, res, metrics, obs in (("jax", jax_res, jax_metrics, jax_obs),
                                    ("port", port_res, port_metrics,
                                     port_obs)):
        ctl = res.DegradationController(clock=lambda: 5.0)
        n_ev = len(obs.recorder.events())
        n_rows = len(obs.cycle_ledger.rows())
        deg = metrics.degradation_transitions_total.value(
            res.STREAMING, "degrade")
        ctl.report(res.STREAMING, "stream_off", True, reason="x", cycle=3)
        ev = obs.recorder.events()[n_ev:]
        rows = obs.cycle_ledger.rows()[n_rows:]
        ctl.enabled = False
        ctl.report(res.STREAMING, "stream_off", False, cycle=4)
        out[name] = (
            metrics.degradation_level.value(res.STREAMING),
            metrics.degradation_transitions_total.value(
                res.STREAMING, "degrade") - deg,
            [(e.kind, e.reason_slug, e.reason, e.cycle, e.detail)
             for e in ev],
            [(r.kind, r.cycle, {k: v for k, v in r.detail.items()
                                if k != "ts"}) for r in rows],
            len(obs.recorder.events()) - n_ev, ctl.level(res.STREAMING))
        ctl.reset()
    assert out["port"][2][0][:2] == (port_obs.DEGRADATION,
                                     "streaming_stream_off")
    assert out["port"] == out["jax"]


def _breaker_trace(pkg):
    res = _mods(pkg)[6]
    if pkg == "jax":
        from kueue_oss_tpu.solver.resilience import SolverHealth
    else:
        from kueue_oss_tpu_torch.solver.resilience import SolverHealth
    now = [0.0]
    ctl = res.DegradationController(clock=lambda: now[0])
    with res.use(ctl):
        h = SolverHealth(failure_threshold=2, cooldown_s=30.0,
                         clock=lambda: now[0])
        steps = [h.allow()]
        h.record_failure()
        h.record_failure()
        steps += [h.state, h.allow(), ctl.level(res.SOLVER)]
        now[0] = 31.0
        steps += [h.allow(), h.state, h.probing,
                  ctl.cooldowns.probing((res.SOLVER, "breaker_open")),
                  h.allow(), h.allow()]  # one probe: the others refused
        h.record_failure()  # the probe failed: open again
        steps += [h.state, h.allow()]
        now[0] = 62.0
        steps += [h.allow(), h.allow()]
        h.record_success()
        steps += [h.state, h.allow(), h.trips, ctl.level(res.SOLVER)]
    return steps, [(e["condition"], e["active"], e["new_level"],
                    e["reason"]) for e in ctl.history]


def test_breaker_single_probe_through_the_ladder():
    port = _breaker_trace("port")
    assert port[0][4:10] == [True, "half-open", True, True, False, False]
    assert port == _breaker_trace("jax")
    steps, history = port
    assert history[0][:3] == ("breaker_open", True, 3)
    assert history[-1][:3] == ("breaker_open", False, 0)


def _relax_trace(pkg):
    res = _mods(pkg)[6]
    now = [1000.0]
    ctl = res.DegradationController(clock=lambda: now[0])
    with res.use(ctl):
        engine = _engine(pkg, _lean_store(pkg))
        engine.relax_enabled = True
        engine.relax_retry_cooldown_s = 300.0
        engine._note_relax_failure(RuntimeError("injected relax fault"),
                                   "relax_error")
        steps = [engine._relax_broken, engine._relax_broken_at,
                 ctl.level(res.SOLVER), engine._relax_available()]
        now[0] += 299.0
        steps.append(engine._relax_available())
        now[0] += 1.0
        steps += [engine._relax_available(), engine._relax_broken,
                  ctl.level(res.SOLVER)]
        engine._note_relax_failure(None, "relax_disagreement")
        engine._relax_broken_at = now[0] - 300.0
        steps += [engine._relax_broken, engine._relax_available(),
                  ctl.level(res.SOLVER)]
    return steps, [(e["condition"], e["active"], e["new_level"],
                    e["reason"]) for e in ctl.history]


def test_relaxed_arm_demotion_and_reprobe():
    port = _relax_trace("port")
    assert port[0][:4] == [True, 1000.0, 2, False]
    assert port == _relax_trace("jax")


def _streaming_trace(pkg):
    types, Store, QueueManager, Scheduler, *_ = _mods(pkg)
    res = _mods(pkg)[6]
    ctl = res.DegradationController(clock=lambda: 0.0)
    with res.use(ctl):
        store = _lean_store(pkg)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        sched = Scheduler(store, QueueManager(store), solver="auto",
                          solver_min_backlog=0, streaming=True, **kw)
        if pkg == "jax":
            sched._solver_engine().mesh_mode = "off"
        sa = sched._streaming_admitter()
        sa._contend(None, "owner_gone")       # a full fence
        steps = [ctl.conditions(res.STREAMING)]
        sa.note_solve_begin()
        sa.note_full_solve()                  # a completed solve re-arms
        steps.append(ctl.conditions(res.STREAMING))
        sa._contend("cq0", "preempt_needed")  # cq0's root contended
        sa.drain(now=5.0)                     # cq0 deferred, cq1 admitted
        steps.append(ctl.conditions(res.STREAMING))
        sa.note_solve_begin()
        sa.note_full_solve()
        steps.append(ctl.conditions(res.STREAMING))
        node_cq = types.ClusterQueue(
            name="cq1", resource_groups=copy.deepcopy(
                store.cluster_queues["cq1"].resource_groups))
        store.upsert_cluster_queue(node_cq)   # a spec change mid-window
        sa.drain(now=6.0)
        steps.append(ctl.conditions(res.STREAMING))
        held = sorted(k for k, w in store.workloads.items()
                      if w.is_quota_reserved)
    return steps, held, [(e["condition"], e["active"], e["new_level"],
                          e["reason"]) for e in ctl.history]


def test_streaming_fences_report_the_ladder():
    port = _streaming_trace("port")
    assert [sorted(c) for c in port[0]] == [
        ["stream_off"], [], ["structural_fence"], [], ["stream_off"]]
    assert port == _streaming_trace("jax")


def _farm_trace(pkg):
    res = _mods(pkg)[6]
    if pkg == "jax":
        from kueue_oss_tpu.federation.farm import FarmScheduler
    else:
        from kueue_oss_tpu_torch.federation.farm import FarmScheduler
    now = [0.0]
    ctl = res.DegradationController(clock=lambda: now[0])
    with res.use(ctl):
        farm = FarmScheduler(clock=lambda: now[0])
        farm.force_throttle("blue", times=2)
        steps = []
        for tenant in ("blue", "red", "blue", "blue"):
            header, _ = farm.run(tenant, lambda: ({"ok": True}, b""))
            now[0] += 1.0
            steps.append((tenant, header.get("ok"),
                          ctl.conditions(res.FEDERATION)))
    return steps, [(e["condition"], e["active"], e["new_level"],
                    e["reason"]) for e in ctl.history]


def test_farm_backpressure_reports_the_federation_rung():
    port = _farm_trace("port")
    assert [s[1] for s in port[0]] == [False, True, False, True]
    assert port == _farm_trace("jax")


def test_devtel_and_breaker_share_one_cooldown_policy():
    """devtel's capture cooldown is the ladder's CooldownPolicy class,
    and the breaker's half-open slot lives on the process-wide
    controller's policy (no private copy of either is left)."""
    from kueue_oss_tpu_torch.obs import devtel
    from kueue_oss_tpu_torch.solver import resilience as breaker_mod
    from kueue_oss_tpu_torch.solver.resilience import SolverHealth

    assert devtel.CooldownPolicy is port_res.CooldownPolicy
    assert isinstance(devtel.DeepCapture().cooldowns,
                      port_res.CooldownPolicy)
    assert not hasattr(breaker_mod, "probe_gate")
    now = [0.0]
    ctl = port_res.DegradationController(clock=lambda: now[0])
    with port_res.use(ctl):
        h = SolverHealth(failure_threshold=1, cooldown_s=1.0,
                         clock=lambda: now[0])
        h.record_failure()
        now[0] = 2.0
        assert h.allow()
        assert ctl.cooldowns.probing((port_res.SOLVER, "breaker_open"))
        h.abandon_probe()
        assert not ctl.cooldowns.probing((port_res.SOLVER,
                                          "breaker_open"))
