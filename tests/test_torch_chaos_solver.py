"""The port's resilience layer under injected faults: the framing
guards, the breaker, the client's retries and deadline, the engine's
plan guard and the scheduler's routing to the sidecar, on the CPU.

Mirrors tests/test_chaos_solver.py (:145-528) case by case on the port
(its ``ChaosSolverServer`` on the CPU, injected clocks and sleeps, so
nothing waits for real but the one deadline-bounded hang), and holds
chip_smoke.py's phase 21 (c) and its copies against the JAX package:
bench.py's chaos scenario and its churn rounds give the same record in
both packages (tests/torch_sidecar_pins.py), the pin chip_smoke.py
holds. Phase 21 (d)'s breaker drive runs here too, on the CPU, with
real sidecar processes.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per worker)

import dataclasses
import os
import socket
import struct
import tempfile
import time

import numpy as np
import pytest
import torch_sidecar_pins as P

from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_oss_tpu_torch.chaos import (
    CORRUPT_PLAN,
    CRASH,
    CRASH_PRE,
    GARBLE,
    HANG,
    OK,
    SLOW,
    TRUNCATE,
    ChaosSolverServer,
    FaultInjector,
)
from kueue_oss_tpu_torch.config import SolverBackendConfig
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
from kueue_oss_tpu_torch.solver.engine import SolverEngine
from kueue_oss_tpu_torch.solver.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    SolverHealth,
    SolverUnavailable,
)
from kueue_oss_tpu_torch.solver.service import (
    SolverClient,
    SolverProtocolError,
    SolverServer,
    _recv,
    _recv_exact,
)

pytestmark = pytest.mark.chaos


def _store(n_cqs=4, quota=8):
    store = Store()
    store.upsert_resource_flavor(ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(ClusterQueue(
            name=f"cq{i}",
            resource_groups=[ResourceGroup(
                covered_resources=["cpu"],
                flavors=[FlavorQuotas(name="f", resources=[
                    ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    return store


def _flood(store, n, start=0):
    for i in range(start, start + n):
        store.add_workload(Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            creation_time=float(i),
            podsets=[PodSet(name="main", count=1, requests={"cpu": 1})]))


def _sock_path():
    return os.path.join(tempfile.mkdtemp(), "solver.sock")


def _client(path, timeout_s=5.0, retries=2):
    # injected no-op sleep: the backoff runs, the test does not wait
    return SolverClient(path, timeout_s=timeout_s, max_retries=retries,
                        backoff_base_s=0.001, sleep=lambda _s: None)


def _engine(store, queues, **kw):
    eng = SolverEngine(store, queues, device="cpu", **kw)
    eng.relax_enabled = False
    return eng


@pytest.fixture()
def chaos_env():
    """store + queues + a chaos server whose injector tests configure."""
    servers = []

    def make(schedule=(), weights=None, seed=0, n_wl=24, **client_kw):
        store = _store()
        _flood(store, n_wl)
        queues = QueueManager(store)
        path = _sock_path()
        injector = FaultInjector(schedule=schedule, weights=weights,
                                 seed=seed)
        srv = ChaosSolverServer(path, injector, device="cpu")
        srv.serve_in_background()
        servers.append(srv)
        engine = _engine(store, queues, remote=_client(path, **client_kw))
        return store, queues, engine, injector

    yield make
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _admitted(store):
    return {k for k, w in store.workloads.items() if w.is_quota_reserved}


def _host_only_admitted(n_wl=24):
    store = _store()
    _flood(store, n_wl)
    Scheduler(store, QueueManager(store)).run_until_quiet(now=0.0, tick=1.0)
    return _admitted(store)


# -- the framing guards ------------------------------------------------------


def test_short_read_raises_protocol_error():
    a, b = socket.socketpair()
    try:
        a.sendall(b"1234")
        a.close()
        with pytest.raises(SolverProtocolError, match="mid-frame"):
            _recv_exact(b, 8)
    finally:
        b.close()


def test_oversized_frame_rejected_before_allocating():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">II", 8, 0xFFFF_FF00))
        with pytest.raises(SolverProtocolError, match="exceeds"):
            _recv(b, max_frame_bytes=1 << 20)
    finally:
        a.close()
        b.close()


def test_garbage_header_raises_protocol_error():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">II", 4, 0) + b"\xff\xfe{!")
        with pytest.raises(SolverProtocolError, match="header"):
            _recv(b, max_frame_bytes=1 << 20)
    finally:
        a.close()
        b.close()


def test_slow_drip_bounded_by_one_shared_deadline():
    a, b = socket.socketpair()
    try:
        t = [0.0]

        def clock():
            t[0] += 0.6
            return t[0]

        a.sendall(b"1234")  # 4 of the 8 requested bytes, then silence
        with pytest.raises(TimeoutError, match="deadline exhausted"):
            _recv_exact(b, 8, deadline=1.0, clock=clock)
    finally:
        a.close()
        b.close()


def test_client_timeout_configurable_from_env(monkeypatch):
    monkeypatch.setenv("KUEUE_SOLVER_TIMEOUT_S", "7.5")
    monkeypatch.setenv("KUEUE_SOLVER_MAX_FRAME_MB", "1")
    monkeypatch.setenv("KUEUE_SOLVER_MAX_SESSIONS", "3")
    c = SolverClient("/nonexistent.sock")
    assert c.timeout_s == 7.5
    assert c.max_frame_bytes == 1 << 20
    c2 = SolverClient("/nonexistent.sock", timeout_s=3.0,
                      max_frame_bytes=64)
    assert c2.timeout_s == 3.0 and c2.max_frame_bytes == 64
    srv = SolverServer(_sock_path(), device="cpu")
    assert srv.max_sessions == 3 and srv.read_timeout_s == 7.5
    srv.server_close()


def test_request_over_the_frame_guard_is_refused_before_sending():
    store = _store()
    _flood(store, 24)
    client = _client("/nonexistent.sock")
    client.max_frame_bytes = 256
    eng = _engine(store, QueueManager(store), remote=client)
    with pytest.raises(SolverUnavailable, match="exceeds"):
        eng.drain(now=0.0)
    assert client.attempts == 0


# -- the breaker's state machine ---------------------------------------------


def test_breaker_state_machine():
    now = [0.0]
    h = SolverHealth(failure_threshold=3, cooldown_s=10.0,
                     clock=lambda: now[0])
    assert h.state == CLOSED and h.allow()
    h.record_failure()
    h.record_failure()
    assert h.state == CLOSED, "below threshold stays closed"
    h.record_failure()
    assert h.state == OPEN and h.trips == 1
    assert not h.allow(), "open refuses while cooling down"
    now[0] = 9.9
    assert not h.allow()
    now[0] = 10.0
    assert h.allow(), "cooldown expiry allows one probe"
    assert h.state == HALF_OPEN and h.probing
    assert not h.allow(), "a second caller mid-probe stays degraded"
    h.record_failure()  # probe failed
    assert h.state == OPEN and h.trips == 2 and not h.probing
    now[0] = 25.0
    assert h.allow()
    h.record_success()  # probe succeeded
    assert h.state == CLOSED and h.consecutive_failures == 0
    h.record_failure()
    assert h.state == CLOSED, "failure count reset by the success"


# -- the client's retries and deadline ---------------------------------------


def test_crash_then_ok_retries_and_succeeds(chaos_env):
    store, queues, engine, injector = chaos_env(schedule=[CRASH, OK])
    result = engine.drain(now=0.0)
    assert result.admitted == 24
    assert injector.injected == {CRASH: 1, OK: 1}
    assert engine.remote.retries == 1 and engine.remote.attempts == 2
    assert engine.remote.failures == {"protocol": 1}
    assert engine.health.state == CLOSED


@pytest.mark.parametrize("fault", [CRASH_PRE, TRUNCATE, GARBLE])
def test_transport_faults_recover_on_retry(chaos_env, fault):
    store, queues, engine, injector = chaos_env(schedule=[fault, OK])
    result = engine.drain(now=0.0)
    assert result.admitted == 24
    assert injector.injected[OK] == 1


def test_retries_exhausted_raises_solver_unavailable(chaos_env):
    store, queues, engine, _ = chaos_env(
        schedule=[CRASH, CRASH, CRASH], retries=2)
    with pytest.raises(SolverUnavailable):
        engine.drain(now=0.0)
    assert engine.health.consecutive_failures == 1, \
        "one drain = one breaker-visible failure, however many retries"
    assert engine.remote_counts["solver_fallback_total"][
        "backend_error"] == 1
    assert _admitted(store) == set()


def test_hang_bounded_by_deadline(chaos_env):
    store, queues, engine, _ = chaos_env(
        weights={HANG: 1}, timeout_s=0.3, retries=0)
    t0 = time.monotonic()
    with pytest.raises(SolverUnavailable):
        engine.drain(now=0.0)
    assert time.monotonic() - t0 < 5.0, \
        "a hung sidecar must not stall past the configured deadline"
    assert engine.remote.failures == {"timeout": 1}


def test_slow_response_within_deadline_succeeds(chaos_env):
    store, queues, engine, injector = chaos_env(
        schedule=[SLOW], timeout_s=10.0)
    injector.slow_s = 0.05
    assert engine.drain(now=0.0).admitted == 24


# -- the plan guard -----------------------------------------------------------


def test_corrupt_plan_rejected_store_unchanged(chaos_env):
    store, queues, engine, _ = chaos_env(schedule=[CORRUPT_PLAN],
                                         retries=0)
    fp_before = queues.membership_fingerprint()
    with pytest.raises(SolverUnavailable, match="divergent"):
        engine.drain(now=0.0)
    assert _admitted(store) == set(), "no corrupt admission committed"
    assert queues.membership_fingerprint() == fp_before
    assert engine.remote_counts["solver_plan_rejected_total"] == 1
    assert engine.remote_counts["solver_fallback_total"][
        "plan_rejected"] == 1
    assert engine.health.consecutive_failures == 1, \
        "a divergent plan is a backend fault and counts on the breaker"


def test_corrupt_full_plan_rejected_before_any_eviction(chaos_env):
    """A FULL drain's corrupt plan (the storm's preemption store) is
    rejected before its evictions: every holder keeps its seat."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store

    store, wave1, wave2 = baseline_preempt_store(
        types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    queues = QueueManager(store)
    path = _sock_path()
    srv = ChaosSolverServer(path, FaultInjector(schedule=[OK,
                                                          CORRUPT_PLAN]),
                            device="cpu")
    srv.serve_in_background()
    try:
        eng = _engine(store, queues, remote=_client(path, retries=0))
        for wl in wave1:
            store.add_workload(wl)
        eng.drain(now=100.0)
        held = _admitted(store)
        for wl in wave2:
            store.add_workload(wl)
        with pytest.raises(SolverUnavailable, match="divergent"):
            eng.drain(now=200.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert held and _admitted(store) == held


def test_plan_fault_catches_out_of_bounds_and_padding_rows():
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads

    store = _store()
    _flood(store, 6)
    engine = _engine(store, QueueManager(store))
    problem, _ = engine.export()
    problem = pad_workloads(problem, 8)
    W1 = problem.wl_cqid.shape[0]
    ok_adm = np.zeros(W1, dtype=bool)
    ok_adm[:6] = True
    opt = np.zeros(W1, dtype=np.int32)
    rnd = np.zeros(W1, dtype=np.int32)
    parked = np.zeros(W1, dtype=bool)
    fault = engine._plan_fault
    assert fault(problem, ok_adm, opt, rnd, parked, None, np.int32(1),
                 False) is None
    bad = ok_adm.copy()
    bad[7] = True
    assert "null/padding" in fault(problem, bad, opt, rnd, parked, None,
                                   np.int32(1), False)
    bad_park = parked.copy()
    bad_park[7] = True
    assert "parks a null/padding" in fault(
        problem, ok_adm, opt, rnd, bad_park, None, np.int32(1), False)
    bad_opt = opt.copy()
    bad_opt[2] = 99
    assert "option index" in fault(problem, ok_adm, bad_opt, rnd, parked,
                                   None, np.int32(1), False)
    assert "shape" in fault(problem, ok_adm[:4], opt, rnd, parked, None,
                            np.int32(1), False)
    assert "not integral" in fault(problem, ok_adm, opt.astype(np.float32),
                                   rnd, parked, None, np.int32(1), False)
    bad_park = parked.copy()
    bad_park[1] = True
    assert "both admitted and parked" in fault(
        problem, ok_adm, opt, rnd, bad_park, None, np.int32(1), False)
    assert "rounds" in fault(problem, ok_adm, opt, rnd, parked, None,
                             np.zeros(2, np.int32), False)
    opt2 = np.zeros((W1, 1), dtype=np.int32)
    vr_float = np.zeros(W1, dtype=np.float32)
    assert "victim_reason dtype" in fault(
        problem, ok_adm, opt2, rnd, parked, vr_float, np.int32(1), True)
    assert "below -1" in fault(problem, ok_adm, opt2,
                               np.full(W1, -2, np.int32), parked,
                               np.zeros(W1, np.int32), np.int32(1), True)


# -- the breaker through the engine and the scheduler ------------------------


def test_breaker_trips_then_probe_untrips():
    now = [0.0]
    store = _store()
    _flood(store, 24)
    queues = QueueManager(store)
    path = _sock_path()  # nothing listening: connect fails at once
    health = SolverHealth(failure_threshold=3, cooldown_s=30.0,
                          clock=lambda: now[0])
    engine = _engine(store, queues, health=health,
                     remote=_client(path, retries=0))
    for _ in range(3):
        with pytest.raises(SolverUnavailable):
            engine.drain(now=0.0)
    assert health.state == OPEN and health.trips == 1
    assert engine.remote.failures == {"connection": 3}
    attempts = engine.remote.attempts
    with pytest.raises(SolverUnavailable, match="breaker"):
        engine.drain(now=0.0)
    assert engine.remote.attempts == attempts, "no socket while open"
    assert engine.remote_counts["solver_fallback_total"][
        "breaker_open"] == 1
    srv = SolverServer(path, device="cpu")
    srv.serve_in_background()
    try:
        now[0] = 31.0
        assert engine.drain(now=0.0).admitted == 24
        assert health.state == CLOSED
        assert engine.remote.attempts == attempts + 1, "exactly one probe"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("end", ["empty_backlog", "fault_before_socket"])
def test_probe_drain_without_an_outcome_frees_the_probe(end, monkeypatch):
    # a half-open probe drain that never reaches the socket releases the
    # probe slot, so the next drain probes (the JAX engine keeps it)
    now = [0.0]
    store = _store()
    _flood(store, 24)
    queues = QueueManager(store)
    path = _sock_path()
    health = SolverHealth(failure_threshold=1, cooldown_s=30.0,
                          clock=lambda: now[0])
    engine = _engine(store, queues, health=health,
                     remote=_client(path, retries=0))
    with pytest.raises(SolverUnavailable):
        engine.drain(now=0.0)
    assert health.state == OPEN
    now[0] = 31.0
    attempts = engine.remote.attempts
    if end == "empty_backlog":
        empty = _store()
        idle = _engine(empty, QueueManager(empty), health=health,
                       remote=engine.remote)
        assert idle.drain(now=0.0).admitted == 0
    else:
        def boom(*_a, **_k):
            raise RuntimeError("export failed")

        monkeypatch.setattr(engine, "pending_backlog", boom)
        with pytest.raises(RuntimeError, match="export failed"):
            engine.drain(now=0.0)
        monkeypatch.undo()
    assert engine.remote.attempts == attempts, "the probe never sent"
    assert health.state == HALF_OPEN and not health.probing
    srv = SolverServer(path, device="cpu")
    srv.serve_in_background()
    try:
        assert engine.drain(now=0.0).admitted == 24
        assert health.state == CLOSED
        assert engine.remote.attempts == attempts + 1, "exactly one probe"
    finally:
        srv.shutdown()
        srv.server_close()


def test_scheduler_completes_round_on_host_when_sidecar_dead():
    store = _store()
    _flood(store, 24)
    queues = QueueManager(store)
    path = _sock_path()
    injector = FaultInjector(weights={CRASH: 1}, seed=7)
    srv = ChaosSolverServer(path, injector, device="cpu")
    srv.serve_in_background()
    try:
        s = Scheduler(store, queues, solver_min_backlog=8, device="cpu")
        engine = _engine(store, queues, scheduler=s,
                         remote=_client(path, retries=1))
        s.solver = engine
        s.run_until_quiet(now=0.0, tick=1.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert injector.faults_injected() >= 1, "the drain did hit the fault"
    assert _admitted(store) == _host_only_admitted(24)
    assert s.solver_counts["unavailable"] >= 1


def test_scheduler_parity_under_mixed_fault_storm():
    store = _store()
    _flood(store, 24)
    queues = QueueManager(store)
    path = _sock_path()
    injector = FaultInjector(
        weights={CRASH: 2, GARBLE: 1, TRUNCATE: 1, CORRUPT_PLAN: 1, OK: 3},
        seed=42)
    srv = ChaosSolverServer(path, injector, device="cpu")
    srv.serve_in_background()
    try:
        s = Scheduler(store, queues, solver_min_backlog=8, device="cpu")
        engine = _engine(store, queues, scheduler=s,
                         remote=_client(path, retries=1))
        s.solver = engine
        s.run_until_quiet(now=0.0, tick=1.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert _admitted(store) == _host_only_admitted(24)


def test_breaker_open_routes_straight_to_host():
    store = _store()
    _flood(store, 24)
    queues = QueueManager(store)
    health = SolverHealth(failure_threshold=1, cooldown_s=1e9,
                          clock=lambda: 0.0)
    health.record_failure()  # pre-tripped
    assert health.state == OPEN
    s = Scheduler(store, queues, solver_min_backlog=8, device="cpu")
    engine = _engine(store, queues, scheduler=s, health=health,
                     remote=_client("/nonexistent.sock", retries=0))
    s.solver = engine
    s.run_until_quiet(now=0.0, tick=1.0)
    assert engine.remote.attempts == 0, \
        "open breaker means zero connection attempts"
    assert s.solver_counts["unavailable"] == 1
    assert _admitted(store) == _host_only_admitted(24)


def test_auto_solver_honors_solver_config(monkeypatch):
    monkeypatch.delenv("KUEUE_SOLVER_SOCKET", raising=False)
    cfg = SolverBackendConfig(
        socket_path="/tmp/cfg-solver.sock", timeout_seconds=12.0,
        max_retries=5, breaker_failure_threshold=7,
        breaker_cooldown_seconds=99.0, max_frame_bytes=1 << 20,
        tenant="t1", sessions_enabled=False)
    s = Scheduler(_store(), QueueManager(_store()), solver="auto",
                  solver_config=cfg, device="cpu")
    engine = s._solver_engine()
    assert isinstance(engine.remote, SolverClient)
    assert engine.remote.socket_path == "/tmp/cfg-solver.sock"
    assert engine.remote.timeout_s == 12.0
    assert engine.remote.max_retries == 5
    assert engine.remote.max_frame_bytes == 1 << 20
    assert engine.remote.tenant == "t1"
    assert engine.remote.use_sessions is False
    assert engine.health.failure_threshold == 7
    assert engine.health.cooldown_s == 99.0
    # a programmatic socket path wins over the environment, which is the
    # fallback for configs that leave it unset
    monkeypatch.setenv("KUEUE_SOLVER_SOCKET", "/tmp/env-solver.sock")
    s2 = Scheduler(_store(), QueueManager(_store()), solver="auto",
                   solver_config=cfg, device="cpu")
    assert s2._solver_engine().remote.socket_path == "/tmp/cfg-solver.sock"
    s3 = Scheduler(_store(), QueueManager(_store()), solver="auto",
                   solver_config=dataclasses.replace(cfg, socket_path=None),
                   device="cpu")
    assert s3._solver_engine().remote.socket_path == "/tmp/env-solver.sock"
    # the mesh mode loads (the single-process mesh arm); the pod-scale
    # coordinator still waits for the multi-process mesh
    assert SolverBackendConfig(mesh="4").mesh == "4"
    with pytest.raises(NotImplementedError, match="item 9b"):
        SolverBackendConfig(coordinator_address="h:1")


def test_auto_solver_picks_up_env_socket(monkeypatch):
    path = _sock_path()
    monkeypatch.setenv("KUEUE_SOLVER_SOCKET", path)
    s = Scheduler(_store(), QueueManager(_store()), solver="auto",
                  device="cpu")
    engine = s._solver_engine()
    assert isinstance(engine.remote, SolverClient)
    assert engine.remote.socket_path == path
    assert engine.health.state == CLOSED
    monkeypatch.delenv("KUEUE_SOLVER_SOCKET")
    s2 = Scheduler(_store(), QueueManager(_store()), solver="auto",
                   device="cpu")
    assert s2._solver_engine().remote is None


def test_auto_solver_drains_through_the_env_socket(monkeypatch):
    """The system's entry point end to end: ``Scheduler(solver="auto")``
    routed by KUEUE_SOLVER_SOCKET drains through the sidecar, and its
    admissions equal the host-only run."""
    path = _sock_path()
    srv = SolverServer(path, device="cpu")
    srv.serve_in_background()
    monkeypatch.setenv("KUEUE_SOLVER_SOCKET", path)
    try:
        store = _store()
        _flood(store, 24)
        s = Scheduler(store, QueueManager(store), solver="auto",
                      solver_min_backlog=8, device="cpu")
        s.run_until_quiet(now=0.0, tick=1.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert s.solver_counts["drains"] == 1
    assert s.solver_counts["unavailable"] == 0
    assert s._solver_engine().last_drain_arm == "remote"
    assert srv.frames == {"sync": 1}
    assert _admitted(store) == _host_only_admitted(24)


def test_remote_engine_still_matches_local_under_clean_server():
    path = _sock_path()
    srv = SolverServer(path, device="cpu")
    srv.serve_in_background()
    try:
        store_l = _store()
        _flood(store_l, 24)
        _engine(store_l, QueueManager(store_l)).drain(now=0.0)
        store_r = _store()
        _flood(store_r, 24)
        engine = _engine(store_r, QueueManager(store_r),
                         remote=_client(path))
        engine.drain(now=0.0)
        assert _admitted(store_r) == _admitted(store_l)
        assert engine.health.state == CLOSED
    finally:
        srv.shutdown()
        srv.server_close()


# -- phase 21 (c) and (d) -----------------------------------------------------


def test_chaos_storm_matches_jax_and_the_pin():
    """bench.py's chaos scenario and its churn rounds: the port's record
    equals the JAX package's, and both equal chip_smoke.py's pin; the
    chip_smoke copy gives it too."""
    import chip_smoke

    want = P.chaos_record(P.JAX)
    got = P.chaos_record(P.PORT)
    assert got == want
    assert want == chip_smoke.CHAOS_REFERENCE
    assert want["plans_rejected"] >= 1 and want["faults_injected"] >= 3
    assert all(h == P.CHAOS_CQS * P.CHAOS_QUOTA for h in want["held"])
    rec, store, _ = chip_smoke.chaos_record("cpu")
    assert rec == want
    chip_smoke._nominal_checks(store)


def test_chip_smoke_copies_match_the_pins_helpers():
    import chip_smoke
    from torch_scheduler_pins import committed_store_digest

    for name in ("CHAOS_CQS", "CHAOS_QUOTA", "CHAOS_WORKLOADS",
                 "CHAOS_SEED", "CHAOS_CHURN", "CHAOS_FINISH"):
        assert getattr(chip_smoke, name) == getattr(P, name), name
    assert committed_store_digest(chip_smoke.chaos_store()) == \
        committed_store_digest(P.chaos_store(P.PORT)) == \
        committed_store_digest(P.chaos_store(P.JAX))
    small = dict(n_cqs=3, quota=5, n_wl=40)
    assert committed_store_digest(chip_smoke.chaos_store(
        small["n_cqs"], small["quota"], small["n_wl"])) == \
        committed_store_digest(P.chaos_store(P.PORT, **small))


def test_breaker_drive_with_real_sidecar_processes():
    """chip_smoke.py's phase 21 (d) on the CPU: a sidecar process, then
    SIGKILLed; host rounds refill every seat while the breaker trips;
    an open round makes no socket attempt; a restarted sidecar process
    and the fake-clock cooldown close it with exactly one probe."""
    import chip_smoke

    path = _sock_path()
    proc = chip_smoke.start_sidecar(path, "cpu")
    try:
        out = chip_smoke.breaker_drive(path, proc, "cpu")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    labels = [r["label"] for r in out["rounds"]]
    assert labels == ["flood", "dead1", "dead2", "open", "probe", "healed"]
    assert out["trips"] == 1
    assert out["failures"] == {"connection": 2}
    assert [r["attempts"] for r in out["rounds"]] == [1, 1, 1, 0, 1, 1]
    assert out["restarted_sidecar"]["launches"] == {
        "leaf_states": 0, "tas_place_sequential": 0, "fill_counts": 0,
        "relax_lp": 0}
