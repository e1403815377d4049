"""The port's ``Scheduler(solver="auto", device="cpu")`` against the JAX
``Scheduler`` over a JAX ``SolverEngine`` (``mesh_mode="off"``), tolerance
0, on identical stores of both packages.

Per ``run_until_quiet`` the committed-store digest (admissions, flavors,
counts, usage, topology assignments, Evicted / Preempted reasons,
requeue state), the held and evicted counts with their reasons, the
host cycles, the device drains and the drains that fell back with
``UnsupportedProblem`` must be equal. The stores: the baseline storm's
two waves (class counts x 0.1), the same storm with a finish that
lazily flushes a cohort before a forced re-drain, fair reclamation, the
admission-fair-sharing backlog, the reduced TAS store, the storm with
memory in bytes (refused at export), and the routing cases of
``tests/test_solver_routing.py`` (flood, trickle churn, a mass free,
backlog exhaustion, zero re-engage fraction, the adaptive gate).

The last tests hold the pin computation of chip_smoke.py's phases 11-13
(``tests/torch_scheduler_pins.py``) to itself at reduced size, hold
chip_smoke.py's copy of the digest to the shared one, and, under ``-m
slow``, recompute the full-size pins and compare them with the ones
chip_smoke.py carries.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import json
from pathlib import Path

import pytest

import torch_scheduler_pins as P
from kueue_oss_tpu_torch import scenarios

ROOT = Path(__file__).resolve().parent.parent
STORM = dict(scale=0.1)


@pytest.fixture(scope="module")
def jax_pkg():
    return P.jax_package()


@pytest.fixture(scope="module")
def port_pkg():
    return P.port_package("cpu")


def _both(fn, jax_pkg, port_pkg, **kw):
    want = fn(jax_pkg, **kw)
    got = fn(port_pkg, **kw)
    assert got == want
    return want


def test_storm_waves_match_jax(jax_pkg, port_pkg):
    want = _both(P.run_waves, jax_pkg, port_pkg,
                 builder=scenarios.baseline_preempt_store, solver=True,
                 **STORM)
    # one device drain and one empty host cycle per wave
    assert [(r["drains"], r["cycles"]) for r in want] == [(1, 1), (1, 1)]
    assert [(r["held"], r["evicted"]) for r in want] == [(600, 0), (30, 600)]
    assert want[1]["reasons"] == {"InClusterQueue": 600}


def test_host_only_twin_reaches_the_same_store(jax_pkg, port_pkg):
    host = _both(P.run_waves, jax_pkg, port_pkg,
                 builder=scenarios.baseline_preempt_store, solver=False,
                 **STORM)
    auto = P.run_waves(port_pkg, scenarios.baseline_preempt_store,
                       solver=True, **STORM)
    assert [r["digest"] for r in host] == [r["digest"] for r in auto]
    assert [r["cycles"] for r in host] == [22, 6]


def _finish_some(store, sched):
    """Finish ten quota holders of one cohort with lazy flushing on, so
    the finishes mark that cohort's parked entries stale; a zero
    re-engage fraction makes the next pass drain them."""
    sched.solver_reengage_fraction = 0.0
    held = sorted(k for k, w in store.workloads.items()
                  if w.is_quota_reserved and not w.is_finished)
    for key in held[:10]:
        sched.finish_workload(key, now=300.0)
    assert sched.queues.any_stale()
    return 300.0


def test_lazy_flush_stale_entries_drain_like_jax(jax_pkg, port_pkg):
    want = _both(P.run_waves, jax_pkg, port_pkg,
                 builder=scenarios.baseline_preempt_store, solver=True,
                 after=_finish_some, **STORM)
    assert want[-1]["drains"] >= 1


def test_fair_reclaim_matches_jax(jax_pkg, port_pkg):
    want = _both(P.run_waves, jax_pkg, port_pkg,
                 builder=scenarios.fair_reclaim_store, solver=True,
                 sched_kw=dict(enable_fair_sharing=True,
                               solver_min_backlog=16),
                 n_cohorts=1)
    assert [r["drains"] for r in want] == [1, 1]
    assert sum(want[1]["reasons"].values()) == want[1]["evicted"] > 0


def test_afs_backlog_matches_jax(jax_pkg, port_pkg):
    want = _both(P.run_afs, jax_pkg, port_pkg, n_cohorts=1,
                 sched_kw=dict(solver_min_backlog=16))
    assert want["drains"] == 1 and want["held"] > 0


def test_reduced_tas_store_matches_jax(jax_pkg, port_pkg):
    want = _both(P.run_tas, jax_pkg, port_pkg, n_racks=4, n_hosts=8,
                 n_cohorts=2, n_cqs=3, n_workloads=600)
    assert (want["drains"], want["cycles"], want["held"]) == (1, 1, 31)


def test_refused_quantities_fall_back_to_host_cycles(jax_pkg, port_pkg):
    want = _both(P.run_waves, jax_pkg, port_pkg,
                 builder=scenarios.refused_quantity_store, solver=True,
                 **STORM)
    assert all(r["drains"] == 0 and r["drain_admitted"] == 0
               for r in want)
    assert [r["unsupported"] for r in want] == [1, 2]
    assert [(r["held"], r["evicted"]) for r in want] == [(600, 0), (30, 600)]


def test_host_tas_head_admitted_as_jax(jax_pkg, port_pkg):
    """A host-only scheduler on a TAS store: the same record as the JAX
    host-only scheduler."""
    want = _both(P.run_tas, jax_pkg, port_pkg, solver=False, n_racks=2,
                 n_hosts=4, n_cohorts=1, n_cqs=2, n_workloads=20)
    assert want["held"] > 0


def test_host_tas_head_raises(port_pkg, monkeypatch):
    """With TASDeviceFillCounts on, a failing device fill raises out of
    the host-only scheduler's run: there is no host fallback."""
    from kueue_oss_tpu_torch import features
    from kueue_oss_tpu_torch.solver import tas_kernels

    def broken(*args, **kwargs):
        raise RuntimeError("leaf_states launch failed")

    monkeypatch.setattr(tas_kernels, "fill_counts_ext", broken)
    features.set_gates({"TASDeviceFillCounts": True})
    try:
        with pytest.raises(RuntimeError, match="leaf_states launch failed"):
            P.run_tas(port_pkg, solver=False, n_racks=2, n_hosts=4,
                      n_cohorts=1, n_cqs=2, n_workloads=20)
    finally:
        features.reset()


def test_auto_needs_cuda_unless_cpu_is_asked():
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    store = Store()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Scheduler(store, QueueManager(store), solver="auto")
        with pytest.raises(RuntimeError, match="CUDA"):
            Scheduler(store, QueueManager(store), solver="auto",
                      streaming=True)
    host = Scheduler(store, QueueManager(store))  # no device touched
    assert host._solver_engine() is None
    # solver_config takes the sessions and relaxed-arm knobs and, since
    # the sidecar is ported, its socket; a host-only scheduler builds no
    # engine (and so no client) from it
    from kueue_oss_tpu_torch.config import SolverBackendConfig

    routed = Scheduler(store, QueueManager(store), solver_config=(
        SolverBackendConfig(socket_path="/tmp/solver.sock")))
    assert routed.solver_config.socket_path == "/tmp/solver.sock"
    assert routed._solver_engine() is None
    cfg = SolverBackendConfig(relax_enabled=False)
    assert Scheduler(store, QueueManager(store),
                     solver_config=cfg).solver_config is cfg
    # streaming rides a solver backend: without one it stays off
    host = Scheduler(store, QueueManager(store), streaming=True)
    assert host._streaming_admitter() is None
    assert host.micro_drain() is None
    assert types.Workload(name="w").podsets


# -- routing (tests/test_solver_routing.py:77-205 on both packages) ---------


def _routing_store(types, store_cls, n_cqs=4, quota=8):
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}",
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    return store


def _flood(types, store, n, start=0):
    for i in range(start, start + n):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1})]))


def _held(store):
    return sorted(k for k, w in store.workloads.items()
                  if w.is_quota_reserved and not w.is_finished)


def _route(case, package):
    """Run one routing case; the log holds the drains so far and the
    committed-store digest after every step."""
    types, store_cls, make, _ = package
    store = _routing_store(types, store_cls)
    kw = dict(solver_min_backlog=16)
    if case == "zero_fraction":
        kw["solver_reengage_fraction"] = 0.0
    s, drains = make(store, True, **kw)
    log = []

    def step(now):
        s.run_until_quiet(now=now)
        log.append((drains.calls, P.committed_store_digest(store)))

    def pin_gate(ema=None, host=None):
        s._drain_cost_ema = ema
        s._host_s_per_adm = host

    if case == "exhaustion":
        _flood(types, store, 20)
        step(0.0)
        for k in _held(store):
            s.finish_workload(k, now=1.0)
        _flood(types, store, 64, start=100)
        step(2.0)
        return log
    _flood(types, store, 64)
    step(0.0)
    if case == "flood":
        return log
    if case == "adaptive":
        pin_gate(1.0 / 32, 0.000001)  # a slow device: stay on the host
        for k in _held(store)[:8]:
            s.finish_workload(k, now=1.0)
        step(1.0)
        pin_gate(0.0000001, 0.01)  # a fast device: drain
        for k in _held(store)[:8]:
            s.finish_workload(k, now=2.0)
        step(2.0)
        return log
    pin_gate()  # the fallback threshold rule
    n = {"trickle": 3, "mass_free": None, "zero_fraction": 2}[case]
    for k in _held(store)[:n]:
        s.finish_workload(k, now=1.0)
    step(1.0)
    return log


@pytest.mark.parametrize("case", ["flood", "trickle", "mass_free",
                                  "exhaustion", "zero_fraction",
                                  "adaptive"])
def test_routing_matches_jax(case, jax_pkg, port_pkg):
    want = _route(case, jax_pkg)
    got = _route(case, port_pkg)
    assert got == want
    calls = [c for c, _ in want]
    expect = {"flood": lambda c: c[0] >= 1,
              "trickle": lambda c: c[1] == c[0],
              "mass_free": lambda c: c[1] > c[0],
              "exhaustion": lambda c: c[1] > c[0] >= 1,
              "zero_fraction": lambda c: c[1] > c[0],
              "adaptive": lambda c: c[0] == c[1] < c[2]}[case]
    assert expect(calls), calls


# -- the pins of chip_smoke.py's phases 11-13 ------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_digest_is_the_shared_one(port_pkg):
    types, store_cls, _, _ = port_pkg
    store, wave1, _ = scenarios.baseline_preempt_store(
        types, store_cls, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    for wl in wave1:
        store.add_workload(wl)
    wl = wave1[0]
    wl.set_condition("Evicted", True, reason="Preempted")
    wl.status.requeue_state = types.RequeueState(count=1, requeue_at=5.0)
    assert (_chip_smoke().committed_store_digest(store)
            == P.committed_store_digest(store))


def test_pin_computation_at_reduced_size():
    """The pin script's self-check: its records at reduced size are the
    port's records, and phase 12's drain admits what its drain-only
    run admits."""
    kw = dict(storm_scale=0.1,
              tas_kwargs=dict(n_racks=4, n_hosts=8, n_cohorts=2, n_cqs=3,
                              n_workloads=600),
              tas_mixed_kwargs=dict(n_workloads=100))
    pins = P.reference_pins(**kw)
    port = P.port_package("cpu")
    assert pins["storm"] == P.run_waves(
        port, scenarios.baseline_preempt_store, solver=True, **STORM)
    assert pins["storm_host"] == P.run_waves(
        port, scenarios.baseline_preempt_store, solver=False, **STORM)
    assert pins["refused"] == P.run_waves(
        port, scenarios.refused_quantity_store, solver=True, **STORM)
    assert pins["tas"] == P.run_tas(port, **kw["tas_kwargs"])
    assert pins["tas_mixed"] == {
        name: P.run_tas_mixed(port, solver=solver, fill=fill,
                              **kw["tas_mixed_kwargs"])
        for name, solver, fill in P.TAS_MIXED_RUNS}


def test_phase12_runs_at_phase4s_depth():
    """Phase 12 runs the TAS store at phase 4's cut, and its pin is the
    JAX scheduler's at that depth (tests/torch_scheduler_pins.py)."""
    smoke = _chip_smoke()
    assert smoke.STEPWISE_WORKLOADS == P.TAS_WORKLOADS
    pin = smoke.SCHEDULER_REFERENCE["tas"]
    assert pin["held"] == smoke.STEPWISE_REFERENCE["admitted"]
    assert pin["parked"] == smoke.STEPWISE_REFERENCE["parked"]


def test_phase14_pins_agree_across_fill_modes():
    """Each phase-14 run must equal its pin, so the two fill modes give
    the same result on the card when their pins are equal: auto with
    auto_fill, host_fill with host."""
    pins = _chip_smoke().SCHEDULER_REFERENCE["tas_mixed"]
    assert pins["auto"] == pins["auto_fill"]
    assert pins["host_fill"] == pins["host"]


def test_phase14_runs_and_depths_are_the_pins():
    """chip_smoke.py's phase-14 runs and their depths (the auto runs cut
    to 1,500 workloads) are the pins script's."""
    smoke = _chip_smoke()
    assert smoke.TAS_MIXED_RUNS == P.TAS_MIXED_RUNS
    assert smoke.TAS_MIXED_WORKLOADS == P.TAS_MIXED_WORKLOADS
    assert set(P.TAS_MIXED_WORKLOADS) == {r[0] for r in P.TAS_MIXED_RUNS}
    pins = smoke.SCHEDULER_REFERENCE["tas_mixed"]
    for name, n in P.TAS_MIXED_WORKLOADS.items():
        assert pins[name]["held"] + pins[name]["parked"] == n, name


@pytest.mark.slow
def test_full_size_pins_are_chip_smokes():
    smoke = _chip_smoke()
    pins = P.reference_pins()
    assert pins == json.loads(json.dumps(smoke.SCHEDULER_REFERENCE))
