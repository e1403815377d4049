"""The port's federation layer on the CPU: a fleet of control planes on
one solver farm (``federation.fleet``, ``federation.farm`` on
``solver/service.py``'s ``SolverServer(device="cpu")``), the member-loss
injector, and the rest of ROADMAP Queue A item 10 (``debug_drain``,
``entry``, ``smoke_kernel``).

- the fleet record of tests/torch_farm_pins.py (bench.py's federation
  phase 1 in a fixed interleaving): each member's ``plan_fingerprint``
  digest and the farm's served counts, pinned from the JAX package; one
  test runs the JAX fleet (pad 64) to hold the pin, one the port's;
- tenant isolation under interleaved churn, farm against dedicated
  twins, and a tenant's eviction healing with one resync while its
  neighbours' sessions stay the same objects;
- identical frames to a JAX and a port farm server: the response's
  ``grant_wait_ms`` and its spans' names and keys;
- backpressure: a throttled tenant degrades to host cycles;
- ``ClusterLossInjector``'s worker faults against JAX's.

The tolerance is exact equality throughout.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per worker)

import os
import socket
import tempfile

import numpy as np
import pytest
import torch_farm_pins as F

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu.chaos import ClusterLossInjector as JaxLoss
from kueue_oss_tpu.federation import farm as jax_farm
from kueue_oss_tpu.multikueue.cluster import MultiKueueCluster as JaxCluster
from kueue_oss_tpu.solver import service as jax_service
from kueue_oss_tpu_torch import config as port_config
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.chaos import ClusterLossInjector as PortLoss
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.federation import (
    FarmScheduler,
    attach_farm,
    build_fleet,
    build_member,
    plan_fingerprint,
)
from kueue_oss_tpu_torch.multikueue.cluster import (
    MultiKueueCluster as PortCluster,
)
from kueue_oss_tpu_torch.solver import full_kernels as pfk
from kueue_oss_tpu_torch.solver import service as port_service
from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable

#: the JAX package's fleet record (``JAX_PLATFORMS=cpu python
#: tests/torch_farm_pins.py``)
FLEET_PIN = {
    "fingerprints": {
        "cp-a/0": "46c68ca763827089aee84ec09c82869e"
                  "28d0dc8980e7cf0b94f967d24aca4d84",
        "cp-a/1": "1addd917adcf567653f104c74bd6fed4"
                  "d98e74af1a695f5c0fd7969ba3172afe",
        "cp-b/0": "d3450c47b0f2f561b674b94fb4594a68"
                  "16d0d4800b0d8fe2072a5b19bd191a55",
        "cp-b/1": "b84d0cd15f5451fff47df0ac9eaa93c1"
                  "c9fd5b7e20c36bbd73f0f96a2ea3a494",
        "cp-c/0": "ffc9ae179c962036d084e22665686ae5"
                  "774599c28d9cb8f27ccccb917aced957",
        "cp-c/1": "2fb7c61d6ce9012e4938178d081c3ec3"
                  "41b061317a7853d7e28d953528fba9f4",
        "cp-d/0": "7b6b4f2a1bc148b06b0e59e0f2c8aa1f"
                  "6f8df808f39736d2bff2933f9f9bf45e",
        "cp-d/1": "7f42ac0971df865a4b2b0e15986e4187"
                  "1c8922958a04fd400af77c5f7dbf5f86"},
    "admitted": {n: 24 for n in F.member_names()},
    "served": {"cp-a": 12, "cp-b": 12, "cp-c": 12, "cp-d": 12},
    "throttled": {},
    "sessions": 8,
}


@pytest.fixture(autouse=True)
def _reset_jax_metrics():
    jax_metrics.reset_all()
    yield
    jax_metrics.reset_all()


def _sock_path():
    return os.path.join(tempfile.mkdtemp(), "farm.sock")


@pytest.fixture()
def farm_server():
    """A port farm server on the CPU loaded from a Configuration."""
    cfg = port_config.load({"federation": {
        "tenantWeights": {"cp-a": 2.0, "cp-b": 1.0}, "quantum": 0.002}})
    assert port_config.validate(cfg) == []
    path = _sock_path()
    srv = port_service.SolverServer(path, device="cpu", max_sessions=16)
    farm = attach_farm(srv, FarmScheduler.from_config(cfg.federation))
    srv.serve_in_background()
    yield path, srv, farm
    srv.shutdown()
    srv.server_close()


def _seed(store):
    F.seed_cluster(port_types, store)


def _warm(fleet, offsets):
    for name, m in fleet.items():
        for i in range(F.WARM_WORKLOADS):
            m.store.add_workload(F.fed_wl(port_types, i + offsets[name]))
        m.drain(now=0.0)


def _twin(name, offset, cycles):
    """A dedicated in-process twin replaying a member's churn."""
    twin = build_member(f"{name}-twin", seed=_seed, pad_to=F.PAD_TO,
                        device="cpu")
    twin.engine.use_sessions = False
    twin.engine.relax_enabled = False
    for i in range(F.WARM_WORKLOADS):
        twin.store.add_workload(F.fed_wl(port_types, i + offset))
    twin.drain(now=0.0)
    F.churn(port_types, twin, cycles, offset + 100, t0=1)
    return twin


# -- the pinned fleet ------------------------------------------------------


def test_jax_fleet_holds_the_pin():
    assert F.fleet_record(F.JAX) == FLEET_PIN


def test_port_fleet_matches_the_jax_pin():
    assert F.fleet_record(F.PORT) == FLEET_PIN


# -- isolation, twins, eviction --------------------------------------------


def test_tenant_sessions_isolated_and_plans_equal_dedicated_twins(
        farm_server):
    path, srv, farm = farm_server
    fleet = build_fleet(["cp-a", "cp-b"], socket_path=path,
                        seed=lambda _n, s: _seed(s), pad_to=F.PAD_TO,
                        device="cpu")
    offsets = {"cp-a": 0, "cp-b": 1000}
    _warm(fleet, offsets)
    uids = {n: offsets[n] + 100 for n in fleet}
    for cyc in range(1, 5):  # interleaved, member by member
        for name, m in fleet.items():
            uids[name] = F.churn(port_types, m, 1, uids[name], t0=cyc)
    members = {f"{n}/0": m for n, m in fleet.items()}
    assert F.cross_tenant_violations(F.PORT, srv, members) == []
    host = F.host_checksums(F.PORT, members)
    assert host["cp-a/0"] != host["cp-b/0"], "vacuous: equal states"
    for name, m in fleet.items():
        twin = _twin(name, offsets[name], 4)
        assert (plan_fingerprint(twin.store, twin.queues)
                == plan_fingerprint(m.store, m.queues)), name
    assert farm.served == {"cp-a": 5, "cp-b": 5}
    assert all(m.engine.remote.last_grant_wait_ms >= 0.0
               for m in fleet.values())


def test_evicted_tenant_heals_with_one_resync(farm_server):
    path, srv, _ = farm_server
    fleet = build_fleet(["cp-a", "cp-b"], socket_path=path,
                        seed=lambda _n, s: _seed(s), pad_to=F.PAD_TO,
                        device="cpu")
    _warm(fleet, {"cp-a": 0, "cp-b": 1000})
    ua = F.churn(port_types, fleet["cp-a"], 2, 100, t0=1)
    ub = F.churn(port_types, fleet["cp-b"], 2, 1100, t0=1)
    with srv._sessions_lock:
        neighbour = {k: (s, s.epoch) for k, s in srv.sessions.items()
                     if k[0] == "cp-a"}
    assert neighbour
    injector = PortLoss(controller=None, farm_server=srv)
    n = injector.evict_farm_tenant("cp-b")
    assert n >= 1 and injector.injected == {"tenant_evict": 1}
    assert srv.session_evictions == {"tenant_evicted": n}
    client_b = fleet["cp-b"].engine.remote
    F.churn(port_types, fleet["cp-b"], 1, ub, t0=3)
    assert client_b.resyncs == {"session_missing": 1}
    assert srv.resyncs == {"session_missing": 1}
    with srv._sessions_lock:
        for k, (sess, epoch) in neighbour.items():
            assert srv.sessions.get(k) is sess and sess.epoch == epoch
    F.churn(port_types, fleet["cp-a"], 1, ua, t0=3)
    assert fleet["cp-a"].engine.remote.resyncs == {}
    assert srv.resyncs == {"session_missing": 1}
    members = {f"{n}/0": m for n, m in fleet.items()}
    assert F.cross_tenant_violations(F.PORT, srv, members) == []
    with pytest.raises(ValueError):
        PortLoss(controller=None).evict_farm_tenant("cp-a")


def test_throttled_tenant_degrades_to_host_cycles(farm_server):
    path, srv, farm = farm_server
    m = build_member("cp-b", socket_path=path, seed=_seed, pad_to=F.PAD_TO,
                     device="cpu", max_retries=0)
    for i in range(F.WARM_WORKLOADS):
        m.store.add_workload(F.fed_wl(port_types, i))
    m.drain(now=0.0)
    served = dict(farm.served)
    attempts = m.engine.remote.attempts
    farm.force_throttle("cp-b")
    admitted = sorted(k for k, w in m.store.workloads.items()
                      if w.is_quota_reserved)
    m.scheduler.finish_workload(admitted[0], now=1.0)
    m.store.add_workload(F.fed_wl(port_types, 100))
    with pytest.raises(SolverUnavailable, match="backpressure"):
        m.drain(now=1.0)
    assert farm.served == served and farm.throttled == {"cp-b": 1}
    assert m.engine.remote.attempts == attempts + 1, "no retry"
    assert m.engine.remote.failures == {"server": 1}
    assert m.engine.health.consecutive_failures == 1
    assert m.engine.remote_counts["solver_fallback_total"][
        "backend_error"] == 1
    # the host cycle admits what the solver did not
    m.scheduler.run_until_quiet(now=2.0)
    assert m.store.workloads["default/w100"].is_quota_reserved
    # the fault is spent: the next drain is served
    m.store.add_workload(F.fed_wl(port_types, 101))
    m.drain(now=3.0)
    assert farm.served["cp-b"] == served["cp-b"] + 1


# -- wire parity with a JAX farm -------------------------------------------


def _exchange(path, header, blob):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(120.0)
    try:
        sock.connect(path)
        jax_service._send(sock, header, blob)
        return jax_service._recv(sock)
    finally:
        sock.close()


def _keys(resp):
    header, _ = resp
    spans = [(s["name"], sorted(s), sorted(s["args"]))
             for s in header["spans"]]
    return sorted(header), spans


def test_grant_wait_and_spans_match_a_jax_farm():
    """Identical frames to a JAX and a port farm server: the same
    response keys, ``grant_wait_ms`` in both, the same spans with the
    same keys; a throttled frame answers the same error."""
    jp, pp = _sock_path(), _sock_path()
    jsrv = jax_service.SolverServer(jp, mesh_mode="off")
    psrv = port_service.SolverServer(pp, device="cpu")
    jfarm = jax_farm.attach_farm(jsrv, weights={"cp-a": 2.0})
    pfarm = attach_farm(psrv, weights={"cp-a": 2.0})
    for srv in (jsrv, psrv):
        srv.serve_in_background()
    try:
        m = build_member("cp-a", seed=_seed, pad_to=F.PAD_TO, device="cpu")
        for i in range(F.WARM_WORKLOADS):
            m.store.add_workload(F.fed_wl(port_types, i))
        problem, _ = m.engine.export()
        from kueue_oss_tpu_torch.solver.tensors import pad_workloads

        problem = pad_workloads(problem, F.PAD_TO)
        meta, blob = port_service.serialize_problem(problem)
        caps = {"full": False, "g_max": 1, "h_max": 32, "p_max": 128,
                "fs_enabled": False, "tenant": "cp-a", "trace_cycle": 7}
        for header in ({**caps, "meta": meta},
                       {**caps, "meta": meta, "kind": "sync", "sid": "s1",
                        "epoch": 0}):
            want = _exchange(jp, header, blob)
            got = _exchange(pp, header, blob)
            assert want[0]["ok"] and got[0]["ok"]
            assert "grant_wait_ms" in want[0] and "grant_wait_ms" in got[0]
            assert _keys(got)[0] == _keys(want)[0]
            assert [s[0] for s in _keys(got)[1]][:1] == ["sidecar_solve"]
            assert _keys(got)[1][0] == _keys(want)[1][0]
        # the grant wait's span shows when the wait is nonzero: a
        # driven clock makes it one step in both farms
        for farm in (jfarm, pfarm):
            farm._clock = _stepping_clock()
        want = _exchange(jp, {**caps, "meta": meta}, blob)
        got = _exchange(pp, {**caps, "meta": meta}, blob)
        assert _keys(got) == _keys(want)
        assert [s[0] for s in _keys(got)[1]] == ["sidecar_solve",
                                                 "farm_grant_wait"]
        assert got[0]["grant_wait_ms"] == want[0]["grant_wait_ms"] > 0
        wait = got[0]["spans"][1]
        assert wait["args"] == want[0]["spans"][1]["args"] == {
            "kind": "grant_wait", "source": "farm:cp-a", "tenant": "cp-a",
            "cycle": 7}
        assert wait["dur_us"] == want[0]["spans"][1]["dur_us"]
        assert wait["end_skew_us"] == got[0]["spans"][0]["dur_us"]
        for farm in (jfarm, pfarm):
            farm.force_throttle("cp-a")
        want = _exchange(jp, {**caps, "meta": meta}, blob)
        got = _exchange(pp, {**caps, "meta": meta}, blob)
        assert got == want and not got[0]["ok"]
    finally:
        for srv in (jsrv, psrv):
            srv.shutdown()
            srv.server_close()


def _stepping_clock():
    """A clock that advances 2.5 ms per read: run() reads it at enqueue,
    after the grant and around the body, so the grant wait is one step."""
    t = [0.0]

    def clock():
        t[0] += 0.0025
        return t[0]

    return clock


# -- member loss: worker faults --------------------------------------------


class _Hub:
    def __init__(self, clusters):
        self.clusters = {c.name: c for c in clusters}


def test_cluster_loss_worker_faults_match_jax():
    hubs = [_Hub([cls(name=n, environment=None)
                  for n in ("w0", "w1", "w2")])
            for cls in (JaxCluster, PortCluster)]
    injectors = [cls(hub, seed=5) for cls, hub in zip((JaxLoss, PortLoss),
                                                      hubs)]
    for now in (10.0, 20.0):
        for inj in injectors:
            for c in inj.controller.clusters.values():
                c.mark_seen(now - 5.0)
    steps = [
        lambda inj: inj.drop_worker(),
        lambda inj: inj.drop_worker(),
        lambda inj: inj.restore_worker("w1", 30.0),
        lambda inj: inj.flap_worker("w2", 40.0),
        lambda inj: inj.drop_worker(),
    ]
    for step in steps:
        out = [step(inj) for inj in injectors]
        assert out[0] == out[1]
        states = [{n: (c.active, c.last_seen)
                   for n, c in inj.controller.clusters.items()}
                  for inj in injectors]
        assert states[0] == states[1]
    assert injectors[1].injected == injectors[0].injected
    assert injectors[1].faults_injected() == injectors[0].faults_injected()
    for inj in injectors:
        for c in inj.controller.clusters.values():
            c.active = False
    for inj in injectors:
        with pytest.raises(ValueError, match="no active worker"):
            inj.drop_worker()


# -- the device rule --------------------------------------------------------


def test_farm_server_and_members_raise_without_cuda():
    """No fallback hides the device: the default is the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_service.SolverServer(_sock_path())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_member("cp-a", socket_path=_sock_path())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fleet(["cp-a"], socket_path=_sock_path())
    from kueue_oss_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


# -- the rest of item 10 -----------------------------------------------------


def test_debug_drain_matches_solve_backlog_full(capsys):
    """debug_drain's rounds are solve_backlog_full's: the same final
    plan on a preemption store, one printed line per round."""
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = baseline_preempt_store(
        port_types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    engine = SolverEngine(store, QueueManager(store), device="cpu")
    for wl in wave1:
        store.add_workload(wl)
    engine.drain(now=100.0)
    for wl in wave2:
        store.add_workload(wl)
    from kueue_oss_tpu_torch.solver.tensors import export_problem

    problem = export_problem(store, engine.pending_backlog(),
                             include_admitted=True, parked={})
    g = int(np.asarray(problem.cq_ngroups).max())
    tensors = pfk.to_device_full(problem, "cpu")
    want = pfk.solve_backlog_full(tensors, g, 8, 32)
    state = pfk.debug_drain(problem, g, h_max=8, p_max=32, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == state["rounds"] == int(want[4])
    assert lines[0].startswith("round 0: heads(mode,req)=")
    assert any("evicted=['" in ln for ln in lines), "vacuous: no victim"
    W = len(problem.wl_keys)
    for got, exp in ((state["admitted"], want[0]), (state["opt"], want[1]),
                     (state["admit_round"], want[2]),
                     (state["parked"], want[3]),
                     (state["victim_reason"], want[7])):
        assert np.array_equal(got[:W].numpy(), exp[:W].numpy())
    pfk.debug_drain(problem, g, h_max=8, p_max=32, max_rounds=2,
                    verbose=False, device="cpu")
    assert capsys.readouterr().out == ""


def test_entry_on_the_cpu():
    from kueue_oss_tpu_torch.entry import entry
    from kueue_oss_tpu_torch.solver.kernels import solve_backlog

    fn, args = entry(device="cpu")
    assert fn is solve_backlog and len(args) == 1
    out = fn(*args)
    assert out[0].device.type == "cpu" and int(out[0].sum()) > 0


def test_smoke_kernel_on_the_cpu(capsys):
    from kueue_oss_tpu_torch import smoke_kernel

    assert smoke_kernel.main(["1", "2", "10", "--device", "cpu"]) == 0
    assert "PARITY OK" in capsys.readouterr().out


# -- chip_smoke.py phase 22 ------------------------------------------------


def test_chip_smoke_copies_match_the_pins_helpers():
    """chip_smoke.py keeps its own copies of the fleet's constants, its
    cluster, its workloads and its churn."""
    import dataclasses

    import chip_smoke

    for mine, theirs in (("FED_WEIGHTS", "WEIGHTS"), ("FED_PLANES",
                                                      "PLANES"),
                         ("FED_QUANTUM_S", "QUANTUM_S"),
                         ("FED_MAX_SESSIONS", "MAX_SESSIONS"),
                         ("FED_PAD_TO", "PAD_TO"),
                         ("FED_WARM", "WARM_WORKLOADS")):
        assert getattr(chip_smoke, mine) == getattr(F, theirs), mine
    a, b = Store(), Store()
    chip_smoke.fed_seed_cluster(a)
    F.seed_cluster(port_types, b)
    assert a.cluster_queues == b.cluster_queues
    assert a.local_queues == b.local_queues
    for i in (0, 7, 10123):
        assert (dataclasses.asdict(chip_smoke.fed_wl(i))
                == dataclasses.asdict(F.fed_wl(port_types, i)))
    members = [build_member(f"cp-{k}", seed=_seed, pad_to=F.PAD_TO,
                            device="cpu") for k in "xy"]
    for m in members:
        for i in range(F.WARM_WORKLOADS):
            m.store.add_workload(F.fed_wl(port_types, i))
        m.drain(now=0.0)
    assert (chip_smoke.fed_churn(members[0], 2, 100, t0=1)
            == F.churn(port_types, members[1], 2, 100, t0=1))
    assert (plan_fingerprint(members[0].store, members[0].queues)
            == plan_fingerprint(members[1].store, members[1].queues))


def test_phase22a_runs_on_the_cpu():
    """chip_smoke.py's phase 22 (a) on the CPU with a short contention:
    isolation, twins, eviction and throttling hold (its own checks)."""
    import chip_smoke

    out = chip_smoke.farm_contention("cpu", device="cpu", secs=0.3)
    assert out["solves"] > 0 and out["evicted_sessions"] == F.PLANES
