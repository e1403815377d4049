"""The port's solver sidecar (``kueue_oss_tpu_torch/solver/service.py``)
against the JAX package's (``kueue_oss_tpu/solver/service.py``), on the
CPU, tolerance 0.

- Wire parity: identical request frames (made by the JAX serializers)
  go to a JAX ``SolverServer`` (no mesh) and a port ``SolverServer``: a
  legacy solve, lean and FULL, a SYNC, a DELTA, and each resync reason
  (``session_missing``, ``epoch_mismatch``, ``checksum_mismatch``,
  ``session_unsupported``). The response headers' ``ok``, ``compact``,
  ``epoch``, ``resync``, ``mesh_devices`` and ``names`` match, and the
  decoded arrays are equal, dtype and bytes.
- Both directions across the wire: the JAX engine and client against
  the port's server, the port's engine and client against the JAX
  server, each against the port's in-process plan.
- Engine parity: ``SolverEngine(remote=SolverClient(...))`` of each
  package over its own sidecar, on ``build_scenario`` stores (the
  seeded preemption stores of tests/test_full_kernel_parity.py, built
  here with either package's types) and a lean store, sessions on, with
  churn: the same plans, committed stores and frame kinds; a dropped
  delta and a checksum mismatch heal by a SYNC on both.
- The delta's wire form read across packages, the torch-free client,
  the server's device default, the session store, and a garbled DELTA
  answered in-band.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per worker)

import io
import os
import random
import socket
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_scheduler_pins import committed_store_digest

from kueue_oss_tpu import metrics
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu.solver import delta as jax_delta
from kueue_oss_tpu.solver import service as jax_service
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import export_problem as jax_export
from kueue_oss_tpu.solver.tensors import pad_workloads as jax_pad
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PortScheduler
from kueue_oss_tpu_torch.solver import delta as port_delta
from kueue_oss_tpu_torch.solver import service as port_service
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine

ROOT = Path(__file__).resolve().parent.parent


def _sock_path():
    # unix socket paths are capped at 108 bytes: a fresh short temp dir
    return os.path.join(tempfile.mkdtemp(), "s.sock")


@pytest.fixture()
def servers():
    """A JAX sidecar without its mesh and a port sidecar on the CPU:
    (jax_path, jax_server, port_path, port_server)."""
    jp, pp = _sock_path(), _sock_path()
    jsrv = jax_service.SolverServer(jp, mesh_mode="off")
    psrv = port_service.SolverServer(pp, device="cpu")
    for srv in (jsrv, psrv):
        srv.serve_in_background()
    yield jp, jsrv, pp, psrv
    for srv in (jsrv, psrv):
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------


def lean_store(types, store_cls, n_wl=24, n_cqs=4, quota=8):
    """tests/test_chaos_solver.py's routing shape: ClusterQueues of one
    flavor, one-cpu workloads."""
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    add_lean(types, store, 0, n_wl, n_cqs)
    return store


def add_lean(types, store, start, n, n_cqs=4):
    for i in range(start, start + n):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % n_cqs}", uid=i + 1,
            creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1})]))


def build_scenario(types, store_cls, seed: int):
    """tests/test_full_kernel_parity.py's ``build_scenario`` with either
    package's types: the same draws, in the same order."""
    rng = random.Random(seed)
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f1"))
    store.upsert_resource_flavor(types.ResourceFlavor(name="f2"))
    n_cohorts = rng.choice([1, 2])
    n_cqs = rng.randint(2, 5)
    two_level = rng.random() < 0.3
    if two_level:
        store.upsert_cohort(types.Cohort(name="root"))
        for i in range(n_cohorts):
            store.upsert_cohort(types.Cohort(name=f"co{i}", parent="root"))
    else:
        for i in range(n_cohorts):
            store.upsert_cohort(types.Cohort(name=f"co{i}"))
    P = types.PreemptionPolicyValue
    within_choices = [P.NEVER, P.LOWER_PRIORITY,
                      P.LOWER_OR_NEWER_EQUAL_PRIORITY]
    reclaim_choices = [P.NEVER, P.LOWER_PRIORITY, P.ANY]
    for c in range(n_cqs):
        flavors = []
        for fname in ("f1", "f2")[:rng.choice([1, 2])]:
            resources = [types.ResourceQuota(
                name="cpu", nominal=rng.choice([1000, 2000]),
                borrowing_limit=rng.choice([None, 1000, 2000]),
                lending_limit=rng.choice([None, 500, 1000]))]
            flavors.append(types.FlavorQuotas(name=fname,
                                              resources=resources))
        bwc_policy = rng.choice([P.NEVER, P.LOWER_PRIORITY])
        bwc = types.BorrowWithinCohort(
            policy=bwc_policy,
            max_priority_threshold=(rng.choice([None, 0, 1])
                                    if bwc_policy != "Never" else None))
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{c}", cohort=f"co{c % n_cohorts}",
            preemption=types.PreemptionPolicy(
                within_cluster_queue=rng.choice(within_choices),
                reclaim_within_cohort=rng.choice(reclaim_choices),
                borrow_within_cohort=bwc),
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"], flavors=flavors)]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{c}", cluster_queue=f"cq{c}"))
    phase1, phase2 = [], []
    n_initial = rng.randint(2, 8)
    n_arriving = rng.randint(2, 8)
    for i in range(n_initial):
        phase1.append(dict(
            name=f"init{i}", queue_name=f"lq{rng.randrange(n_cqs)}",
            priority=rng.randint(0, 2), creation_time=float(i),
            cpu=rng.choice([400, 700, 1000, 1500])))
    for i in range(n_arriving):
        phase2.append(dict(
            name=f"new{i}", queue_name=f"lq{rng.randrange(n_cqs)}",
            priority=rng.randint(0, 3), creation_time=100.0 + i,
            cpu=rng.choice([400, 700, 1000, 1500, 2500])))
    return store, phase1, phase2


def mk_wl(types, spec, uid):
    return types.Workload(
        name=spec["name"], queue_name=spec["queue_name"],
        priority=spec["priority"], creation_time=spec["creation_time"],
        uid=uid, podsets=[types.PodSet(name="main", count=1,
                                       requests={"cpu": spec["cpu"]})])


def scenario_setup(port: bool, seed: int):
    """tests/test_solver_service.py's ``_setup``: phase 1 admitted by
    host cycles at t = 50, phase 2 added. Returns (store, queues,
    scheduler)."""
    types = port_types if port else jax_types
    store, phase1, phase2 = build_scenario(
        types, PortStore if port else JaxStore, seed)
    queues = (PortQueues if port else JaxQueues)(store)
    sched = (PortScheduler if port else JaxScheduler)(store, queues)
    uid = 1
    for spec in phase1:
        store.add_workload(mk_wl(types, spec, uid))
        uid += 1
    sched.run_until_quiet(now=50.0, tick=1.0)
    for spec in phase2:
        store.add_workload(mk_wl(types, spec, uid))
        uid += 1
    return store, queues, sched


def _held(store):
    return {k for k, w in store.workloads.items()
            if w.is_quota_reserved and not w.is_finished}


def engine_of(port: bool, store, queues, sched=None, remote=None):
    if port:
        eng = PortEngine(store, queues, device="cpu", scheduler=sched,
                         remote=remote)
    else:
        eng = JaxEngine(store, queues, scheduler=sched, remote=remote,
                        mesh_mode="off")
    eng.relax_enabled = False
    return eng


# ---------------------------------------------------------------------------
# wire parity: identical frames to both servers
# ---------------------------------------------------------------------------


def _exchange(path, header, blob):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(120.0)
    try:
        sock.connect(path)
        jax_service._send(sock, header, blob)
        return jax_service._recv(sock)
    finally:
        sock.close()


def _decoded(body):
    if not body:
        return {}
    data = np.load(io.BytesIO(body))
    return {n: data[n] for n in data.files}


def _same_response(jresp, presp, label):
    (jh, jb), (ph, pb) = jresp, presp
    for key in ("ok", "compact", "epoch", "resync", "mesh_devices",
                "names", "error"):
        if key == "error":
            assert ("error" in jh) == ("error" in ph), (label, jh, ph)
            continue
        assert jh.get(key) == ph.get(key), (label, key, jh, ph)
    jd, pd = _decoded(jb), _decoded(pb)
    assert sorted(jd) == sorted(pd), label
    for name in jd:
        assert pd[name].dtype == jd[name].dtype, (label, name)
        assert pd[name].shape == jd[name].shape, (label, name)
        assert pd[name].tobytes() == jd[name].tobytes(), (label, name)
    return jh, jd


def _wire_problem(full: bool):
    """A padded JAX export (the FULL one with its engine's caps) and the
    store and queues it came from."""
    if full:
        store, queues, _ = scenario_setup(False, 3)
        eng = engine_of(False, store, queues)
        pending = eng.pending_backlog()
        problem = jax_export(store, pending, include_admitted=True,
                             parked={})
        h_max, p_max = eng._size_caps(problem)
        caps = {"full": True, "g_max": int(problem.cq_ngroups.max()),
                "h_max": h_max, "p_max": p_max, "fs_enabled": False}
    else:
        store = lean_store(jax_types, JaxStore)
        queues = JaxQueues(store)
        eng = engine_of(False, store, queues)
        problem = jax_export(store, eng.pending_backlog())
        caps = {"full": False, "g_max": 1, "h_max": 32, "p_max": 128,
                "fs_enabled": False}
    return jax_pad(problem, 128), caps, store, queues, eng


@pytest.mark.parametrize("full", [False, True], ids=["lean", "full"])
def test_wire_parity_legacy_sync_delta(servers, full):
    jp, _, pp, _ = servers
    problem, caps, store, queues, eng = _wire_problem(full)
    meta, blob = jax_service.serialize_problem(problem)
    legacy = {**caps, "meta": meta}
    h, d = _same_response(_exchange(jp, legacy, blob),
                          _exchange(pp, legacy, blob), "legacy")
    assert h["ok"] and d["admitted"].any(), "vacuous: nothing admitted"

    # a session: the JAX encoder's SYNC, then a DELTA after a small edit
    sess = jax_delta.HostDeltaSession()
    slotted, frame = sess.advance(problem)
    assert frame.delta is None
    meta, blob = jax_service.serialize_problem(slotted)
    sync = {**caps, "meta": meta, "kind": "sync", "sid": "s1",
            "epoch": frame.epoch, "checksum": frame.checksum}
    h, _ = _same_response(_exchange(jp, sync, blob),
                          _exchange(pp, sync, blob), "sync")
    assert h["ok"] and h["compact"] and h["epoch"] == frame.epoch
    if full:
        wl = next(w for w in store.workloads.values()
                  if not w.is_quota_reserved)
        wl.priority += 5
        store.update_workload(wl)
        nxt = jax_export(store, eng.pending_backlog(),
                         include_admitted=True, parked={})
    else:
        add_lean(jax_types, store, 24, 2)
        nxt = jax_export(store, eng.pending_backlog())
    slotted, frame = sess.advance(jax_pad(nxt, 128))
    assert frame.delta is not None, frame.full_reason
    dh, dblob = jax_delta.serialize_delta(frame.delta)
    delta = {**caps, **dh, "kind": "delta", "sid": "s1"}
    h, d = _same_response(_exchange(jp, delta, dblob),
                          _exchange(pp, delta, dblob), "delta")
    assert h["ok"] and h["epoch"] == frame.epoch and "adm_idx" in d


@pytest.mark.parametrize("reason", ["session_missing", "epoch_mismatch",
                                    "checksum_mismatch",
                                    "session_unsupported"])
def test_wire_parity_resync_reasons(servers, reason):
    jp, jsrv, pp, psrv = servers
    problem, caps, store, _, eng = _wire_problem(False)
    sess = jax_delta.HostDeltaSession()
    slotted, frame = sess.advance(problem)
    meta, blob = jax_service.serialize_problem(slotted)
    sync = {**caps, "meta": meta, "kind": "sync", "sid": "s1",
            "epoch": frame.epoch, "checksum": frame.checksum}
    if reason != "session_missing":
        _same_response(_exchange(jp, sync, blob),
                       _exchange(pp, sync, blob), "sync")
    add_lean(jax_types, store, 24, 2)
    _, frame = sess.advance(jax_pad(jax_export(store,
                                               eng.pending_backlog()), 128))
    dh, dblob = jax_delta.serialize_delta(frame.delta)
    delta = {**caps, **dh, "kind": "delta", "sid": "s1"}
    if reason == "epoch_mismatch":
        delta["base_epoch"] += 5
    if reason == "checksum_mismatch":
        delta["checksum"] = (delta["checksum"] + 1) & 0xFFFFFFFF
    if reason == "session_unsupported":
        resp = (jax_service.solve_request(delta, dblob, None),
                port_service.solve_request(delta, dblob, None))
    else:
        resp = (_exchange(jp, delta, dblob), _exchange(pp, delta, dblob))
    h, _ = _same_response(*resp, reason)
    assert h == {"ok": False, "resync": reason}
    if reason == "checksum_mismatch":
        assert not jsrv.sessions and not psrv.sessions, \
            "a diverged session is dropped"
    if reason != "session_unsupported":
        assert psrv.resyncs == {reason: 1}


def test_delta_and_problem_wire_forms_cross_packages():
    """Each package reads the other's DELTA and problem frames, and the
    checksum of a state is the same number in both."""
    store = lean_store(jax_types, JaxStore)
    eng = engine_of(False, store, JaxQueues(store))
    sess = jax_delta.HostDeltaSession()
    sess.advance(jax_pad(jax_export(store, eng.pending_backlog()), 128))
    add_lean(jax_types, store, 24, 3)
    _, frame = sess.advance(jax_pad(jax_export(store,
                                               eng.pending_backlog()), 128))
    d = frame.delta
    for ser, de in ((jax_delta.serialize_delta,
                     port_delta.deserialize_delta),
                    (port_delta.serialize_delta,
                     jax_delta.deserialize_delta)):
        h, blob = ser(d)
        back = de(h, blob)
        assert (back.epoch, back.base_epoch, back.checksum,
                back.meta_delta, back.stats) == (
            d.epoch, d.base_epoch, d.checksum, d.meta_delta, d.stats)
        assert sorted(back.row_updates) == sorted(d.row_updates)
        for name, (idx, vals) in d.row_updates.items():
            bi, bv = back.row_updates[name]
            assert bi.dtype == idx.dtype and bv.dtype == vals.dtype
            np.testing.assert_array_equal(bi, idx)
            np.testing.assert_array_equal(bv, vals)
        assert sorted(back.repl) == sorted(d.repl)
    # identical bytes from either serializer's payload arrays
    jh, jb = jax_delta.serialize_delta(d)
    ph, pb = port_delta.serialize_delta(d)
    assert jh == ph
    jd = np.load(io.BytesIO(jb))
    pd = np.load(io.BytesIO(pb))
    assert jd.files == pd.files
    # problems, and the checksum over them
    problem = jax_pad(jax_export(store, eng.pending_backlog()), 64)
    meta, blob = jax_service.serialize_problem(problem)
    back = port_service.deserialize_problem(meta, blob)
    kwargs, meta2 = port_delta.problem_wire_state(back)
    jk, jm = jax_delta.problem_wire_state(problem)
    assert port_delta.state_checksum(kwargs, meta2) == \
        jax_delta.state_checksum(jk, jm)
    pmeta, pblob = port_service.serialize_problem(back)
    again = jax_service.deserialize_problem(pmeta, pblob)
    for name in jax_delta.ARRAY_FIELDS:
        a, b = getattr(problem, name), getattr(again, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(b).dtype == np.asarray(a).dtype, name
            np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# both directions across the wire
# ---------------------------------------------------------------------------


def _lean_drains(port: bool, remote=None, cycles=3):
    """The lean store drained, then churned (two finishes and two
    arrivals a cycle); returns (held set per drain, engine, store)."""
    types = port_types if port else jax_types
    store = lean_store(types, PortStore if port else JaxStore)
    queues = (PortQueues if port else JaxQueues)(store)
    sched = (PortScheduler if port else JaxScheduler)(store, queues)
    eng = engine_of(port, store, queues, sched, remote)
    eng.pad_to = 128
    held = []
    eng.drain(now=0.0)
    held.append(_held(store))
    for c in range(1, cycles + 1):
        for key in sorted(_held(store))[:2]:
            sched.finish_workload(key, now=float(c))
        add_lean(types, store, 100 + 2 * c, 2)
        eng.drain(now=float(c))
        held.append(_held(store))
    return held, eng, store


def test_jax_client_uses_the_port_server(servers):
    _, _, pp, psrv = servers
    held, eng, store = _lean_drains(
        False, jax_service.SolverClient(pp))
    want, _, pstore = _lean_drains(True)
    assert held == want
    assert committed_store_digest(store) == committed_store_digest(pstore)
    assert eng.remote.frames_by_kind.get("sync") == 1
    assert eng.remote.frames_by_kind.get("delta", 0) >= 2
    assert psrv.frames.get("delta", 0) >= 2
    sess = next(iter(psrv.sessions.values()))
    assert sess.device.delta_updates >= 2, "the port resident state"


def test_port_client_uses_the_jax_server(servers):
    jp, jsrv, _, _ = servers
    held, eng, store = _lean_drains(True, port_service.SolverClient(jp))
    want, _, pstore = _lean_drains(True)
    assert held == want
    assert committed_store_digest(store) == committed_store_digest(pstore)
    assert eng.remote.frames_by_kind.get("sync") == 1
    assert eng.remote.frames_by_kind.get("delta", 0) >= 2
    assert eng.last_drain_arm == "remote"
    # a legacy (sessions off) solve through the JAX server too
    store = lean_store(port_types, PortStore)
    eng = engine_of(True, store, PortQueues(store),
                    remote=port_service.SolverClient(jp, sessions=False))
    assert eng.drain(now=0.0).admitted == 24
    assert eng.remote.frames_by_kind == {"legacy": 1}
    assert eng._delta_sessions == {}, "no session layer without sessions"


# ---------------------------------------------------------------------------
# engine parity: each package's engine over its own sidecar
# ---------------------------------------------------------------------------


def _scenario_drains(port: bool, seed: int, remote):
    store, queues, sched = scenario_setup(port, seed)
    eng = engine_of(port, store, queues, sched, remote)
    eng.pad_to = 128
    types = port_types if port else jax_types
    out = []

    def kind():
        return None if remote is None else remote.last_frame[0]

    res = eng.drain(now=200.0)
    out.append((res.admitted_keys, res.evicted_keys, res.rounds, kind()))
    for c in range(1, 3):
        held = sorted(_held(store))
        for key in held[:1]:
            sched.finish_workload(key, now=200.0 + c)
        store.add_workload(mk_wl(types, dict(
            name=f"late{c}", queue_name="lq0", priority=1,
            creation_time=300.0 + c, cpu=400), 1000 + c))
        res = eng.drain(now=200.0 + c)
        out.append((res.admitted_keys, res.evicted_keys, res.rounds,
                    kind()))
    return out, committed_store_digest(store), remote


@pytest.mark.parametrize("seed", [3, 7])
def test_engine_remote_full_matches_jax(servers, seed):
    jp, _, pp, _ = servers
    want, jdig, jc = _scenario_drains(False, seed,
                                      jax_service.SolverClient(jp))
    got, pdig, pc = _scenario_drains(True, seed,
                                     port_service.SolverClient(pp))
    assert got == want
    assert pdig == jdig
    assert pc.frames_by_kind == jc.frames_by_kind
    assert pc.bytes_by_kind == jc.bytes_by_kind, "identical frames"
    assert "delta" in pc.frames_by_kind, pc.frames_by_kind
    # the in-process port engine reaches the same store
    local, ldig, _ = _scenario_drains(True, seed, None)
    assert [r[:3] for r in local] == [r[:3] for r in got] and ldig == pdig


def test_engine_remote_lean_matches_jax(servers):
    jp, _, pp, _ = servers
    want, jeng, jstore = _lean_drains(False, jax_service.SolverClient(jp))
    got, peng, pstore = _lean_drains(True, port_service.SolverClient(pp))
    assert got == want
    assert committed_store_digest(pstore) == committed_store_digest(jstore)
    assert peng.remote.frames_by_kind == jeng.remote.frames_by_kind
    assert peng.remote.bytes_by_kind == jeng.remote.bytes_by_kind


def _two_sided(servers, heal):
    """Run the lean churn on both packages, with ``heal(server)`` applied
    to each sidecar before the last cycle; returns both sides' clients,
    engines and servers after it."""
    jp, jsrv, pp, psrv = servers
    sides = []
    for port, path, srv in ((False, jp, jsrv), (True, pp, psrv)):
        service = port_service if port else jax_service
        types = port_types if port else jax_types
        store = lean_store(types, PortStore if port else JaxStore, n_wl=48)
        queues = (PortQueues if port else JaxQueues)(store)
        sched = (PortScheduler if port else JaxScheduler)(store, queues)
        eng = engine_of(port, store, queues, sched,
                        service.SolverClient(path))
        eng.pad_to = 128
        eng.drain(now=0.0)
        for c in (1, 2, 3):
            if c == 3:
                heal(srv)
            for key in sorted(_held(store))[:2]:
                sched.finish_workload(key, now=float(c))
            add_lean(types, store, 100 + 2 * c, 2)
            eng.drain(now=float(c))
        sides.append((eng, srv, store))
    return sides


def test_dropped_delta_heals_by_sync_like_jax(servers):
    """The sidecar loses the session (a restart): the next DELTA is
    answered ``session_missing`` and the client re-seeds it with a SYNC
    in the same call; the re-seeded state equals the host's."""
    resync0 = metrics.solver_resync_total.collect().get(
        ("session_missing",), 0)

    def wipe(srv):
        with srv._sessions_lock:
            srv.sessions.clear()

    (jeng, jsrv, jstore), (peng, psrv, pstore) = _two_sided(servers, wipe)
    assert metrics.solver_resync_total.collect().get(
        ("session_missing",), 0) == resync0 + 1
    assert peng.remote.resyncs == {"session_missing": 1}
    assert peng.remote.frames_by_kind == jeng.remote.frames_by_kind
    assert peng.remote.frames_by_kind.get("resync") == 1
    assert committed_store_digest(pstore) == committed_store_digest(jstore)
    host = peng._delta_sessions["lean"]
    sidecar = next(iter(psrv.sessions.values()))
    assert sidecar.epoch == host.epoch
    hk, hm = host._last
    assert (port_delta.state_checksum(sidecar.kwargs, sidecar.meta)
            == port_delta.state_checksum(hk, hm))


def test_checksum_mismatch_heals_by_sync_like_jax(servers):
    """A flipped bit in the sidecar's resident mirror is caught by the
    DELTA's checksum, answered ``checksum_mismatch`` and healed."""
    def flip(srv):
        sess = next(iter(srv.sessions.values()))
        sess.kwargs["wl_prio"][0] ^= 1

    (jeng, _, jstore), (peng, psrv, pstore) = _two_sided(servers, flip)
    assert peng.remote.resyncs == {"checksum_mismatch": 1}
    assert psrv.resyncs == {"checksum_mismatch": 1}
    assert peng.remote.frames_by_kind == jeng.remote.frames_by_kind
    assert committed_store_digest(pstore) == committed_store_digest(jstore)


# ---------------------------------------------------------------------------
# the server itself
# ---------------------------------------------------------------------------


def test_server_runs_on_cuda_unless_the_cpu_is_asked():
    path = _sock_path()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_service.SolverServer(path)
    srv = port_service.SolverServer(path, device="cpu")
    assert srv.device.type == "cpu"
    srv.server_close()


def test_session_store_is_lru_capped_and_drops_tenants():
    srv = port_service.SolverServer(_sock_path(), device="cpu",
                                    max_sessions=2)
    try:
        a = srv.session("a", "t1")
        srv.session("b", "t1")
        srv.session("c", "t2")  # evicts ("t1", "a"), the oldest
        assert srv.get_session("a", "t1") is None
        assert srv.session_evictions == {"lru": 1}
        assert srv.session("b", "t1") is not a
        assert srv.drop_tenant("t1") == 1
        assert srv.session_evictions == {"lru": 1, "tenant_evicted": 1}
        assert list(srv.sessions) == [("t2", "c")]
        srv.drop_session("c", "t2")
        assert not srv.sessions
    finally:
        srv.server_close()


def test_garbled_delta_is_answered_in_band_and_never_reaches_the_device(
        servers):
    """A DELTA whose rows lie outside the session's arrays fails on the
    host mirror and is answered in-band; a SYNC then works. The resident
    state refuses such rows itself too."""
    _, _, pp, psrv = servers
    problem, caps, store, _, eng = _wire_problem(False)
    sess = jax_delta.HostDeltaSession()
    slotted, frame = sess.advance(problem)
    meta, blob = jax_service.serialize_problem(slotted)
    sync = {**caps, "meta": meta, "kind": "sync", "sid": "g",
            "epoch": frame.epoch, "checksum": frame.checksum}
    assert _exchange(pp, sync, blob)[0]["ok"]
    add_lean(jax_types, store, 24, 2)
    _, frame = sess.advance(jax_pad(jax_export(store,
                                               eng.pending_backlog()), 128))
    d = frame.delta
    name = next(iter(d.row_updates))
    idx, vals = d.row_updates[name]
    d.row_updates[name] = (idx + 10_000, vals)
    dh, dblob = jax_delta.serialize_delta(d)
    h, _ = _exchange(pp, {**caps, **dh, "kind": "delta", "sid": "g"},
                     dblob)
    assert h["ok"] is False and "error" in h
    assert _exchange(pp, sync, blob)[0]["ok"], "the server still serves"
    dev = port_delta.DeviceResidentProblem("cpu")
    buf = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unique rows"):
        dev._write_rows(buf, np.array([4]), np.array([1], np.int32))
    with pytest.raises(ValueError, match="unique rows"):
        dev._write_rows(buf, np.array([-1]), np.array([1], np.int32))
    assert psrv.frames.get("delta") == 1


def test_client_and_framing_need_no_torch():
    """The client, the framing and the chaos fault names import no
    torch: a control plane without it solves through a sidecar (here a
    stand-in that answers every request with one compact plan)."""
    script = textwrap.dedent("""
        import sys
        sys.modules["torch"] = None  # any import of torch now fails
        import io, os, socketserver, tempfile, threading
        import numpy as np
        from kueue_oss_tpu_torch.api import types as T
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.solver import service
        from kueue_oss_tpu_torch.solver.tensors import (
            export_problem, pad_workloads)
        import kueue_oss_tpu_torch.chaos  # noqa: F401

        class Fake(socketserver.StreamRequestHandler):
            def handle(self):
                header, blob = service._recv(self.request)
        """) + textwrap.indent(textwrap.dedent("""
                problem = service.deserialize_problem(header["meta"], blob)
                W1 = problem.wl_cqid.shape[0]
                out = (np.arange(W1) < 3, np.zeros(W1, np.int32),
                       np.zeros(W1, np.int32), np.zeros(W1, bool),
                       np.int32(1))
                buf = io.BytesIO()
                np.savez(buf, **service.compact_plan(out, False))
                service._send(self.request, {"ok": True, "compact": True,
                                             "epoch": 0}, buf.getvalue())
        """), "        ") + textwrap.dedent("""
        path = os.path.join(tempfile.mkdtemp(), "s.sock")
        srv = socketserver.ThreadingUnixStreamServer(path, Fake)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        store = Store()
        store.upsert_resource_flavor(T.ResourceFlavor(name="f"))
        store.upsert_cluster_queue(T.ClusterQueue(
            name="cq", resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"], flavors=[T.FlavorQuotas(
                    name="f", resources=[T.ResourceQuota(
                        name="cpu", nominal=8)])])]))
        store.upsert_local_queue(T.LocalQueue(name="lq",
                                              cluster_queue="cq"))
        for i in range(5):
            store.add_workload(T.Workload(
                name=f"w{i}", queue_name="lq", uid=i + 1,
                podsets=[T.PodSet(name="main", count=1,
                                  requests={"cpu": 1})]))
        queues = QueueManager(store)
        pending = {n: q.snapshot_order() for n, q in queues.queues.items()}
        problem = pad_workloads(export_problem(store, pending), 8)
        plan = service.SolverClient(path).solve(problem, full=False)
        assert plan[0].sum() == 3 and len(plan) == 6
        srv.shutdown()
        assert "torch" not in [m.split(".")[0] for m in sys.modules
                               if sys.modules[m] is not None]
        print("solved without torch")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "solved without torch" in proc.stdout
