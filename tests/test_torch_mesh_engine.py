"""The port's engine, sidecar and chaos injector on the mesh arm, on
the CPU.

The port's mesh is the CPU repeated by ``meshutil.set_virtual_devices``
(8, reset after every test); the JAX runs are the conftest's 8 virtual
devices, pinned in tests/torch_mesh_pins.py (their FULL compiles would
cost ~20 s a test). Tolerance 0 throughout.

- the engine with ``mesh_force`` under finish-and-submit churn
  (tests/test_solver_delta.py:510-587): every drain's ordered admitted
  and evicted keys, its rounds, the arm, the committed store, the
  session's interleave and the shard imbalance equal JAX's;
- the interleave's balance against the classic slot policy
  (tests/test_multihost.py:225-290, pinned) and its width-change
  migration (:293-318, live against the JAX session);
- the sidecar's mesh (tests/test_solver_delta.py:589-707): resident
  sessions placed on it and a forced resync, a mesh fault served on the
  single device with the mesh tripped, a client without a mesh learning
  the width;
- the chaos injector's mesh faults (tests/test_chaos_solver.py:
  599-708), the mesh gauges (tests/test_metrics.py:271-320), the
  ladder's ``mesh_broken`` and the scheduler's ``solver_config.mesh``.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import os
import tempfile

import numpy as np
import pytest

import torch_mesh_pins as pins
from kueue_oss_tpu_torch import metrics, resilience
from kueue_oss_tpu_torch.chaos import MeshFaultInjector
from kueue_oss_tpu_torch.config import SolverBackendConfig
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
from kueue_oss_tpu_torch.solver import meshutil
from kueue_oss_tpu_torch.solver.engine import SolverEngine
from kueue_oss_tpu_torch.solver.service import SolverClient, SolverServer

PORT = pins.PORT


@pytest.fixture(autouse=True)
def virtual_mesh():
    meshutil.set_virtual_devices(8)
    yield
    meshutil.set_virtual_devices(0)
    resilience.reset()


def _admitted(store):
    return {k for k, w in store.workloads.items() if w.is_quota_reserved}


def _fallbacks(slug: str) -> float:
    return metrics.solver_fallback_total.value(slug)


# ---------------------------------------------------------------------------
# the engine's mesh arm
# ---------------------------------------------------------------------------


def test_engine_mesh_churn_equals_the_jax_pin():
    engines = []
    got = pins.engine_churn(PORT, keep=engines)
    assert got == pins.PINS["engine_churn"]
    assert {d["arm"] for d in got["drains"]} == {"mesh"}
    assert got["interleave"] == 8
    dev = engines[0]._device_states["full-mesh"]
    assert dev.mesh_placed and dev.delta_updates > 0
    assert dev.donated_update_bytes > 0
    # each shard holds only its block of the resident rows
    t = dev.tensors
    assert t.rows == got["rows"] and t.block == got["rows"] // 8
    assert all(s.wl_req.shape[0] == t.block for s in t.shards)


@pytest.mark.parametrize("classic", [False, True],
                         ids=["interleaved", "classic"])
def test_interleave_balance_equals_the_jax_pins(classic):
    got = pins.interleave_balance(PORT, classic)
    want = pins.PINS["interleave"]["classic" if classic else "interleaved"]
    assert got == want
    if classic:
        assert got["interleave"] == 1 and got["imbalance"] > 1.1
    else:
        assert got["interleave"] == 8 and got["imbalance"] <= 1.1


def test_interleave_width_change_is_one_counted_migration():
    """The JAX and the port session on one export: a width change is one
    ``interleave_migration`` resync, and both lay the slots out alike."""
    from kueue_oss_tpu.solver.delta import HostDeltaSession as JSession
    from kueue_oss_tpu.solver.tensors import pad_workloads
    from kueue_oss_tpu_torch.convert import problem_from_arrays
    from kueue_oss_tpu_torch.solver.delta import HostDeltaSession
    from test_sharded_full import export_from_seed

    jprob = pad_workloads(export_from_seed(7), 31)
    pprob = problem_from_arrays(jprob)
    sessions = (JSession(), HostDeltaSession())
    reasons = [[], []]
    for step, width in enumerate((None, 8, 8)):
        for i, (sess, prob) in enumerate(zip(sessions, (jprob, pprob))):
            if width is not None:
                sess.set_interleave(width)
            _, frame = sess.advance(prob)
            reasons[i].append(frame.full_reason)
    assert reasons[0] == reasons[1] == ["first_sync",
                                        "interleave_migration", None]
    assert sessions[0]._slots == sessions[1]._slots
    assert sessions[1].migrations == 1
    assert len({sessions[1]._shard_of(s)
                for s in sessions[1]._slots.values()}) > 1


def test_chip_smoke_mesh_pins_hold_on_the_cpu():
    """Phase 25 (a) and (b)'s pins (the JAX engine on a 4-device mesh)
    against the port's same drives on 4 virtual CPU devices."""
    import chip_smoke

    meshutil.set_virtual_devices(pins.CHIP_WIDTH)
    assert chip_smoke.MESH_WIDTH == pins.CHIP_WIDTH
    assert pins.chip_tas(PORT) == chip_smoke.MESH_REFERENCE["tas"]
    assert pins.chip_storm(PORT) == chip_smoke.MESH_REFERENCE["storm"]


def test_mesh_drain_reports_the_mesh_metrics():
    st = pins.store(PORT)
    for i in range(24):
        st.add_workload(pins.wl(PORT, i))
    _qm, _sched, engine = pins.mesh_engine(PORT, st)
    n0 = metrics.solver_shard_imbalance.total_count()
    engine.drain(now=0.0)
    assert engine.last_drain_arm == "mesh"
    assert metrics.solver_mesh_devices.value() == 8
    assert metrics.solver_shard_imbalance.total_count() == n0 + 1
    # a drain on the single device zeroes the gauge
    engine.mesh_force = False
    engine.mesh_min_workloads = 1 << 20
    pins.wl(PORT, 99)
    st.add_workload(pins.wl(PORT, 99))
    engine.drain(now=1.0)
    assert engine.last_drain_arm == "single"
    assert metrics.solver_mesh_devices.value() == 0


def test_scheduler_wires_the_solver_configs_mesh():
    st = pins.store(PORT)
    sched = Scheduler(st, QueueManager(st), solver="auto", device="cpu",
                      solver_config=SolverBackendConfig(mesh="4"))
    engine = sched._solver_engine()
    assert engine.mesh_mode == "4"
    assert meshutil.mesh_devices(engine._mesh()) == 4
    off = Scheduler(st, QueueManager(st), solver="auto", device="cpu",
                    solver_config=SolverBackendConfig(mesh="off"))
    assert off._solver_engine()._mesh() is None


def test_router_probes_the_mesh_then_follows_the_cheaper_arm():
    st = pins.store(PORT)
    engine = SolverEngine(st, QueueManager(st), device="cpu")
    engine.mesh_min_workloads = 10
    mesh = engine._mesh()
    assert meshutil.mesh_devices(mesh) == 8
    assert engine._pick_mesh_arm("lean", 5) is None       # below floor
    assert engine._pick_mesh_arm("lean", 50) is mesh      # probe mesh
    engine._arm_ema[("lean", "mesh")] = 2e-4
    assert engine._pick_mesh_arm("lean", 50) is None      # probe single
    engine._arm_ema[("lean", "single")] = 1e-4
    assert engine._pick_mesh_arm("lean", 50) is None      # mesh slower
    assert engine._arm_ema[("lean", "mesh")] < 2e-4       # loser decays
    engine._arm_ema[("lean", "mesh")] = 5e-5
    assert engine._pick_mesh_arm("lean", 50) is mesh


# ---------------------------------------------------------------------------
# chaos: mesh faults
# ---------------------------------------------------------------------------


def _flood(st, n, start=0):
    for i in range(start, start + n):
        st.add_workload(pins.wl(PORT, i))


def _chaos_engine(n_wl=24):
    st = pins.store(PORT, preemption=False)
    _flood(st, n_wl)
    _qm, sched, engine = pins.mesh_engine(PORT, st)
    sched.solver = engine
    sched.solver_min_backlog = 0
    return st, sched, engine


def _host_only(n_wl=24, extra=0):
    st = pins.store(PORT, preemption=False)
    _flood(st, n_wl)
    _flood(st, extra, start=100)
    Scheduler(st, QueueManager(st), device="cpu").run_until_quiet(
        now=0.0, tick=1.0)
    return _admitted(st)


def test_mesh_device_loss_falls_back_to_the_single_device():
    st, _sched, engine = _chaos_engine()
    injector = MeshFaultInjector(engine)
    before = _fallbacks("mesh_error")
    injector.lose_mesh(1)
    result = engine.drain(now=0.0)
    assert engine.last_drain_arm == "single" and result.admitted > 0
    assert _fallbacks("mesh_error") == before + 1
    assert injector.injected == {"mesh_lost": 1}
    assert resilience.controller.active(resilience.SOLVER, "mesh_broken")
    # tripped until a refresh heals it
    assert engine._mesh() is None
    assert injector.restore() == 8
    assert engine._mesh() is not None
    assert _admitted(st) == _host_only()


def test_full_device_loss_degrades_the_round_to_host_cycles():
    st, sched, engine = _chaos_engine()
    injector = MeshFaultInjector(engine)
    mesh0, dev0 = _fallbacks("mesh_error"), _fallbacks("device_error")
    injector.lose_all(1)
    assert sched.run_until_quiet(now=0.0, tick=1.0) >= 1
    assert _admitted(st) == _host_only()
    assert _fallbacks("mesh_error") == mesh0 + 1
    assert _fallbacks("device_error") == dev0 + 1
    assert injector.injected == {"mesh_lost": 1, "single_lost": 1}


def test_full_arm_mesh_fault_falls_back_within_the_drain():
    """The FULL drain's mesh arm rides the same chain: a healthy twin
    drains on the mesh, the faulted one re-runs the same preemption
    drain on the single device, and both commit the same store."""
    from torch_scheduler_pins import committed_store_digest

    def build():
        st = pins.store(PORT, quota=6, preemption=True)
        for i in range(24):
            st.add_workload(pins.wl(PORT, i, prio=i % 3))
        return st, pins.mesh_engine(PORT, st)[2]

    st_m, eng_m = build()
    eng_m.drain(now=0.0)
    assert eng_m.last_drain_arm == "mesh"
    st_f, eng_f = build()
    injector = MeshFaultInjector(eng_f)
    before = _fallbacks("mesh_error")
    injector.lose_mesh(1)
    eng_f.drain(now=0.0)
    assert eng_f.last_drain_arm == "single"
    assert _fallbacks("mesh_error") == before + 1
    assert committed_store_digest(st_f) == committed_store_digest(st_m)


def test_mesh_shrink_repads_and_keeps_the_plans():
    st, _sched, engine = _chaos_engine()
    injector = MeshFaultInjector(engine)
    engine.drain(now=0.0)
    assert engine.last_drain_arm == "mesh"
    sess = engine._delta_sessions["lean"]
    syncs0 = sess.full_syncs
    assert injector.shrink(4) == 4
    _flood(st, 8, start=100)
    engine.drain(now=1.0)
    assert engine.last_drain_arm == "mesh"
    assert sess.full_syncs > syncs0
    assert sess._interleave == 4
    assert engine._device_states["lean-mesh"].tensors.mesh.size == 4
    assert _admitted(st) == _host_only(extra=8)


# ---------------------------------------------------------------------------
# the sidecar's mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def server():
    path = os.path.join(tempfile.mkdtemp(), "solver.sock")
    srv = SolverServer(path, device="cpu")
    srv.serve_in_background()
    yield path, srv
    srv.shutdown()
    srv.server_close()


def _churn_run(engine, st, sched, cycles=4, churn=2, uid0=100):
    uid = uid0
    for cyc in range(1, cycles + 1):
        admitted = sorted(k for k, w in st.workloads.items()
                          if w.is_quota_reserved and not w.is_finished)
        for k in admitted[:churn]:
            sched.finish_workload(k, now=float(cyc))
        for _ in range(churn):
            st.add_workload(pins.wl(PORT, uid))
            uid += 1
        engine.drain(now=float(cyc))
    return uid


def _remote(path, mesh_mode=None, n=48):
    st = pins.store(PORT, preemption=False)
    _flood(st, n)
    qm = QueueManager(st)
    sched = Scheduler(st, qm, device="cpu")
    engine = SolverEngine(st, qm, scheduler=sched, device="cpu",
                          remote=SolverClient(path), mesh_mode=mesh_mode)
    engine.pad_to = 64
    return st, sched, engine


def test_sidecar_mesh_sessions_resync_and_match_the_host_path(server):
    path, srv = server
    assert meshutil.mesh_devices(srv.mesh) == 8
    srv.mesh_min_workloads = 0
    st, sched, engine = _remote(path)
    engine.drain(now=0.0)
    assert engine.remote.frames_by_kind.get("sync") == 1
    uid = _churn_run(engine, st, sched, cycles=2)
    assert engine.remote.frames_by_kind.get("delta", 0) >= 1
    sess = next(iter(srv.sessions.values()))
    assert sess.device.mesh_placed
    resyncs0 = metrics.solver_resync_total.total()
    with srv._sessions_lock:
        srv.sessions.clear()
    uid = _churn_run(engine, st, sched, cycles=1, uid0=uid)
    assert metrics.solver_resync_total.total() == resyncs0 + 1
    _churn_run(engine, st, sched, cycles=1, uid0=uid)
    assert next(iter(srv.sessions.values())).device.delta_updates >= 1
    # the sessionless, mesh-less in-process path admits the same set
    st_h = pins.store(PORT, preemption=False)
    _flood(st_h, 48)
    qh = QueueManager(st_h)
    sched_h = Scheduler(st_h, qh, device="cpu")
    eng_h = SolverEngine(st_h, qh, scheduler=sched_h, device="cpu",
                         mesh_mode="off")
    eng_h.use_sessions = False
    eng_h.pad_to = 64
    eng_h.drain(now=0.0)
    _churn_run(eng_h, st_h, sched_h, cycles=4)
    assert _admitted(st) == _admitted(st_h)


def test_sidecar_mesh_fault_serves_the_single_device_and_trips(
        server, monkeypatch):
    path, srv = server
    srv.mesh_min_workloads = 0
    calls = {"n": 0}

    def boom(mesh):
        calls["n"] += 1
        raise RuntimeError("injected sidecar mesh loss")

    monkeypatch.setattr(meshutil, "lean_mesh_solver", boom)
    before = _fallbacks("mesh_error")
    st, sched, engine = _remote(path)
    result = engine.drain(now=0.0)
    assert calls["n"] == 1 and result.admitted == 32
    assert srv.mesh is None
    assert not next(iter(srv.sessions.values())).device.mesh_placed
    assert _fallbacks("mesh_error") == before + 1
    monkeypatch.undo()
    _churn_run(engine, st, sched, cycles=1)
    assert calls["n"] == 1


def test_client_without_a_mesh_learns_the_sidecars_width(server):
    path, srv = server
    srv.mesh_min_workloads = 0
    st, sched, engine = _remote(path, mesh_mode="off")
    engine.drain(now=0.0)
    assert engine.remote.remote_mesh_devices == 8
    assert not next(iter(srv.sessions.values())).device.mesh_placed
    _churn_run(engine, st, sched, cycles=1)
    sess = next(iter(srv.sessions.values()))
    assert sess.device.mesh_placed
    assert sess.kwargs["wl_cqid"].shape[0] % 8 == 0
    assert np.asarray(sess.kwargs["wl_cqid"]).shape[0] == 72
