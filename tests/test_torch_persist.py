"""The port's durable control plane (kueue_oss_tpu_torch/persist) against
the JAX package's.

- Equal bytes: ``canonical_dump`` of seeded stores from both packages
  (the scenario builders, a scheduler store mid-flight and a drained
  one), and the WAL segments and checkpoint states the same event
  sequence (the crash harness's scenario, host and ``--solver``) writes.
- Cross recovery: a directory the JAX package wrote recovers in the port
  to the JAX store's dump, and the reverse.
- The cut fields: a JAX record whose JAX-only field is off its default
  (``Workload.labels``, ``ClusterQueue.labels``) or a priority class
  raises in the port's decode, naming it.
- A torn tail at every record boundary (and inside every frame) replays
  and recovers the same in both; intent fencing, the invariant auditor
  (its background thread too), log shipping and the warm standby give
  the same records.
- The crash points ``pre_fsync`` / 12, ``torn_tail`` / 20,
  ``post_fsync_pre_apply`` / 6, ``mid_checkpoint`` / 0 and ``mid_drain``
  / 2 with ``--solver``, through ``python -m
  kueue_oss_tpu_torch.persist.crashtest --device cpu``: each killed run
  recovers to the JAX harness's no-crash dump, byte for byte.

The tolerance is exact byte equality throughout. The JAX solver drains
are the crash harness's few-workload backlogs (one compile per shape).
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kueue_oss_tpu import obs as jax_obs
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.persist import codec as jax_codec
from kueue_oss_tpu.persist import crashtest as jax_ct
from kueue_oss_tpu.persist import wal as jax_wal
from kueue_oss_tpu.persist.auditor import InvariantAuditor as JaxAuditor
from kueue_oss_tpu.persist.manager import PersistenceManager as JaxManager
from kueue_oss_tpu.persist.shipping import WarmStandby as JaxStandby
from kueue_oss_tpu_torch import obs as port_obs
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.persist import codec as port_codec
from kueue_oss_tpu_torch.persist import crashtest as port_ct
from kueue_oss_tpu_torch.persist import wal as port_wal
from kueue_oss_tpu_torch.persist.auditor import InvariantAuditor as PortAuditor
from kueue_oss_tpu_torch.persist.manager import (
    PersistenceManager as PortManager,
)
from kueue_oss_tpu_torch.persist.shipping import WarmStandby as PortStandby

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_slo_engines():
    """The drains here feed each package's process-wide SLO engine with
    their waits; reset both after each test, so no burn-rate alert they
    raised reaches a later test's health rollup on the same worker."""
    yield
    jax_obs.slo_engine.reset()
    port_obs.slo_engine.reset()


def _stores():
    from kueue_oss_tpu.core.store import Store as JaxStore
    from kueue_oss_tpu_torch.core.store import Store as PortStore

    return {"jax": (jax_types, JaxStore), "port": (port_types, PortStore)}


def _scenario(name, types, Store):
    from kueue_oss_tpu_torch import scenarios

    if name == "tas_drain":
        return scenarios.tas_drain_store(types, Store, n_racks=2, n_hosts=4,
                                         n_cohorts=1, n_cqs=2,
                                         n_workloads=40)
    if name == "tas_mixed":
        return scenarios.tas_mixed_store(types, Store, n_workloads=60)
    if name == "streaming":
        return scenarios.streaming_store(types, Store)
    store, wave1, wave2 = scenarios.baseline_preempt_store(
        types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    for wl in wave1 + wave2:
        store.add_workload(wl)
    return store


@pytest.mark.parametrize("name", ["tas_drain", "tas_mixed", "streaming",
                                  "storm"])
def test_canonical_dump_of_seeded_stores(name):
    dumps = {}
    for pkg, (types, Store) in _stores().items():
        codec = jax_codec if pkg == "jax" else port_codec
        dumps[pkg] = codec.canonical_dump(_scenario(name, types, Store))
    assert dumps["port"] == dumps["jax"]
    # and the round trip through the port's decode is exact
    back = port_codec.store_from_dict(json.loads(dumps["jax"]))
    assert port_codec.canonical_dump(back) == dumps["jax"]


def _scheduler(pkg, store):
    if pkg == "jax":
        from kueue_oss_tpu.core.queue_manager import QueueManager
        from kueue_oss_tpu.scheduler.scheduler import Scheduler
        return Scheduler(store, QueueManager(store))
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    return Scheduler(store, QueueManager(store), device="cpu")


def test_canonical_dump_of_a_scheduler_store_mid_flight():
    """Host cycles over the storm's two waves, with finishes and an
    eviction between them: the dumps after each step are equal."""
    from kueue_oss_tpu_torch import scenarios

    seen = {}
    for pkg, (types, Store) in _stores().items():
        codec = jax_codec if pkg == "jax" else port_codec
        store, wave1, wave2 = scenarios.baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        sched = _scheduler(pkg, store)
        out = []
        for wl in wave1:
            store.add_workload(wl)
        for c in range(3):
            sched.schedule(now=10.0 + c)
            out.append(codec.canonical_dump(store))
        held = sorted(k for k, w in store.workloads.items()
                      if w.is_quota_reserved)
        for key in held[:3]:
            sched.finish_workload(key, now=20.0)
        sched.evict_workload(held[3], reason="Preempted", message="m",
                             now=21.0, preemption_reason="InClusterQueue")
        for wl in wave2:
            store.add_workload(wl)
        sched.run_until_quiet(now=30.0, tick=0.0)
        out.append(codec.canonical_dump(store))
        seen[pkg] = out
    assert seen["port"] == seen["jax"]


def _play(pkg, d, solver, fsync="always", ship_to=None, **mkw):
    """The crash harness's scenario in process, persistence attached."""
    if pkg == "jax":
        from kueue_oss_tpu.core.store import Store
        m = JaxManager(d, fsync=fsync, checkpoint_interval_seconds=0.0,
                       ship_to=ship_to, **mkw)
        store = Store()
        m.attach(store)
        sched, engine = jax_ct._build_control_plane(store, solver)
        if engine is not None:
            engine.mesh_mode = "off"
        jax_ct.play(store, sched, engine, m)
        return store, m, jax_codec
    from kueue_oss_tpu_torch.core.store import Store
    m = PortManager(d, fsync=fsync, checkpoint_interval_seconds=0.0,
                    ship_to=ship_to, **mkw)
    store = Store()
    m.attach(store)
    sched, engine = port_ct._build_control_plane(store, solver, "cpu")
    port_ct.play(store, sched, engine, m)
    return store, m, port_codec


def _files(d):
    return {n: (Path(d) / n).read_bytes() for n in sorted(os.listdir(d))
            if n.startswith(("wal-", "checkpoint-"))}


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    """Both packages' durability directories of the harness's scenario
    (host and --solver), with each live store's dump."""
    out = {}
    for solver in (False, True):
        for pkg in ("jax", "port"):
            d = str(tmp_path_factory.mktemp(f"{pkg}{int(solver)}"))
            store, m, codec = _play(pkg, d, solver)
            out[(pkg, solver)] = (d, codec.canonical_dump(store))
            m.close()
    return out


@pytest.mark.parametrize("solver", [False, True], ids=["host", "solver"])
def test_wal_segments_and_checkpoints_are_the_jax_bytes(played, solver):
    jd, jdump = played[("jax", solver)]
    pd, pdump = played[("port", solver)]
    assert pdump == jdump
    jf, pf = _files(jd), _files(pd)
    assert list(pf) == list(jf)
    assert any(n.startswith("checkpoint-") for n in pf)
    assert pf == jf
    # a frame's bytes are one encoding in both packages
    for path in (Path(pd) / n for n in pf if n.startswith("wal-")):
        for rec in port_wal.replay_wal(str(path))[0][:20]:
            assert port_wal.encode_frame(rec) == jax_wal.encode_frame(rec)


@pytest.mark.parametrize("solver", [False, True], ids=["host", "solver"])
def test_cross_package_recovery(played, solver, tmp_path):
    """A JAX directory recovers in the port to the JAX store's dump,
    and a port directory in the JAX package to the port's."""
    for src, dst in (("jax", "port"), ("port", "jax")):
        d, live = played[(src, solver)]
        copy = tmp_path / f"{src}-to-{dst}"
        shutil.copytree(d, copy)
        manager = PortManager if dst == "port" else JaxManager
        codec = port_codec if dst == "port" else jax_codec
        m = manager(str(copy))
        rr = m.recover()
        assert codec.canonical_dump(rr.store) == live, (src, dst)
        assert rr.checkpoint_id == 1 and rr.replayed_events > 0
        m.close()


def _jax_dir_with(tmp_path, mutate):
    from kueue_oss_tpu.core.store import Store

    d = str(tmp_path / "jax")
    m = JaxManager(d, fsync="always", checkpoint_interval_seconds=0.0)
    store = Store()
    m.attach(store)
    jax_ct.ensure_objects(store)
    jax_ct.ensure_batch(store, jax_ct.BATCH_A[:2])
    mutate(store)
    return d, m, store


@pytest.mark.parametrize("where", ["wal", "checkpoint"])
@pytest.mark.parametrize("field", ["Workload.labels", "ClusterQueue.labels",
                                   "WorkloadPriorityClass"])
def test_cut_fields_refuse_to_decode(tmp_path, where, field):
    """A JAX record whose JAX-only state is off its default raises in the
    port's decode, naming the field; at its default it decodes."""
    def mutate(store):
        if field == "Workload.labels":
            wl = store.workloads["default/a0"]
            wl.labels = {"team": "ml"}
            store.update_workload(wl)
        elif field == "ClusterQueue.labels":
            cq = store.cluster_queues["cq-a"]
            cq.labels = {"tier": "gold"}
            store.upsert_cluster_queue(cq)
        else:
            store.upsert_priority_class(
                jax_types.WorkloadPriorityClass(name="high", value=100))

    d, m, store = _jax_dir_with(tmp_path, mutate)
    if where == "checkpoint":
        m.checkpoint()
    m.close()
    pm = PortManager(d)
    with pytest.raises(port_codec.CutFieldError, match=field):
        pm.recover()
    pm.close()


def test_cut_fields_at_their_defaults_decode(tmp_path):
    d, m, store = _jax_dir_with(tmp_path, lambda s: None)
    live = jax_codec.canonical_dump(store)
    m.checkpoint()
    jax_ct.ensure_batch(store, jax_ct.BATCH_A[2:4])
    live = jax_codec.canonical_dump(store)
    m.close()
    pm = PortManager(d)
    assert port_codec.canonical_dump(pm.recover().store) == live
    pm.close()


def _boundaries(path):
    frames = list(port_wal.iter_frames(path))
    assert frames == list(jax_wal.iter_frames(path))
    cuts = set()
    for off, n in frames:
        cuts |= {off, off + 1, off + n // 2, off + n - 1}
    size = os.path.getsize(path)
    return sorted(c for c in cuts if c <= size), frames


def test_torn_tail_at_every_record_boundary(played, tmp_path):
    """The host scenario's last segment cut at every frame boundary and
    inside every frame: both packages replay the same records with the
    same torn flag, and recover the same store."""
    d, _ = played[("jax", False)]
    seg = sorted(n for n in os.listdir(d) if n.startswith("wal-"))[-1]
    src = os.path.join(d, seg)
    cuts, frames = _boundaries(src)
    data = Path(src).read_bytes()
    ends = {off + n for off, n in frames} | {0}
    for i, cut in enumerate(cuts):
        work = tmp_path / f"c{i}"
        shutil.copytree(d, work)
        (work / seg).write_bytes(data[:cut])
        jr = jax_wal.replay_wal(str(work / seg))
        pr = port_wal.replay_wal(str(work / seg))
        assert pr == jr and pr[1] == (cut not in ends)
        dumps = []
        for manager, codec in ((JaxManager, jax_codec),
                               (PortManager, port_codec)):
            w2 = tmp_path / f"c{i}{codec is port_codec}"
            shutil.copytree(work, w2)
            m = manager(str(w2))
            rr = m.recover()
            dumps.append((codec.canonical_dump(rr.store), rr.to_dict()))
            m.close()
        assert dumps[0] == dumps[1], cut


def _fenced(manager, d):
    """A hand-built WAL: an applied intent, a lost one, a fence the log
    skipped past (a violation), and a delete that settles a fence."""
    from kueue_oss_tpu_torch.core.store import Store

    store = Store()
    port_ct.ensure_objects(store)
    wl = port_ct._mk_wl("x", 1, "lq-a", 1000, 0, 1.0)
    store.add_workload(wl)
    obj = port_codec.to_dict(wl)
    w = port_wal.WriteAheadLog(os.path.join(d, "wal-00000000.log"),
                               fsync="off")
    for kind, o in (("ResourceFlavor", store.resource_flavors["default"]),
                    ("ClusterQueue", store.cluster_queues["cq-a"]),
                    ("LocalQueue", store.local_queues["default/lq-a"])):
        w.append({"t": "event", "verb": "update", "kind": kind,
                  "obj": port_codec.to_dict(o)})
    w.append({"t": "event", "verb": "add", "kind": "Workload", "obj": obj})
    for rv, ev_rv in ((1, 2), (2, None), (5, 9)):
        w.append({"t": "intent", "op": "admit", "wl": "default/x",
                  "rv": rv, "cycle": rv, "cq": "cq-a"})
        if ev_rv is not None:
            w.append({"t": "event", "verb": "update", "kind": "Workload",
                      "obj": dict(obj, resource_version=ev_rv)})
    w.append({"t": "intent", "op": "evict", "wl": "default/x", "rv": 9,
              "cycle": 9, "cq": "cq-a"})
    w.append({"t": "event", "verb": "delete", "kind": "Workload",
              "obj": dict(obj, resource_version=9)})
    w.close()
    m = manager(d)
    rr = m.recover()
    m.close()
    return rr.to_dict(), sorted(rr.store.workloads)


def test_intent_fencing(tmp_path):
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    port = _fenced(PortManager, str(tmp_path / "p"))
    assert port[0]["replayed_intents"] == 4
    assert port[0]["fence_violations"] == 1
    assert port[0]["unapplied_intents"] == 1
    assert port == _fenced(JaxManager, str(tmp_path / "j"))


def test_invariant_auditor_parity(played):
    """Drift planted in both packages' recovered stores gives the same
    violations; auto-heal repairs the indexes in both; the background
    thread audits on its cadence. Each package's last-violations gauge
    is put back afterwards (the JAX health rollup reads it)."""
    from kueue_oss_tpu import metrics as jax_metrics
    from kueue_oss_tpu_torch import metrics as port_metrics

    gauges = [(m.invariant_last_violations,
               m.invariant_last_violations.value())
              for m in (jax_metrics, port_metrics)]
    try:
        _audit_parity(played)
    finally:
        for gauge, value in gauges:
            gauge.set(value=value)


def test_background_auditor_heals_beside_a_scheduler():
    """The background auditor (auto-heal on, a 1 ms cadence) audits and
    heals while a scheduler thread adds, admits, finishes and deletes
    workloads. Drift is planted under the store lock (a ghost key in the
    finished-transition set), so every plant is confirmed and healed:
    each heal rebuilds the indexes by walking the workloads dict while
    the scheduler writes. The interpreter switches threads every 10 us
    here. No audit pass may fail, the scheduler thread must not raise,
    and the indexes end exact (a clean audit)."""
    import threading
    import time

    from kueue_oss_tpu_torch import metrics as port_metrics
    from kueue_oss_tpu_torch.core.store import Store as PortStore

    store = PortStore()
    port_ct.ensure_objects(store)
    sched = _scheduler("port", store)
    errors0 = port_metrics.invariant_audit_errors_total.value()
    gauge0 = port_metrics.invariant_last_violations.value()
    aud = PortAuditor(store, auto_heal=True)
    failures = []
    done = threading.Event()

    def churn():
        try:
            uid = 1000
            for r in range(200):
                for i in range(6):
                    uid += 1
                    store.add_workload(port_ct._mk_wl(
                        f"c{r}-{i}", uid, ("lq-a", "lq-b")[i % 2], 1000,
                        i % 3, float(r)))
                sched.run_until_quiet(now=float(r), max_cycles=20,
                                      tick=0.0)
                held = sorted(k for k, w in store.workloads.items()
                              if w.is_quota_reserved and not w.is_finished)
                for key in held[:6]:
                    sched.finish_workload(key, now=float(r))
                for key in [k for k, w in list(store.workloads.items())
                            if w.is_finished][:6]:
                    store.delete_workload(key)
        except BaseException as e:  # surfaced by the main thread
            failures.append(e)
        finally:
            done.set()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    aud.start(interval_s=0.001)
    worker = threading.Thread(target=churn)
    try:
        worker.start()
        planted = 0
        while not done.is_set():
            with store._lock:
                store._finished_counted.add(f"default/ghost-{planted}")
            planted += 1
            deadline = time.monotonic() + 5.0
            while (aud.heals_run < planted and not done.is_set()
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        worker.join()
    finally:
        aud.stop()
        sys.setswitchinterval(switch)
    try:
        assert failures == []
        assert (port_metrics.invariant_audit_errors_total.value()
                == errors0)
        assert aud.heals_run >= 10
        # a plant the thread had no pass left to heal is healed here
        assert [v.check for v in aud.audit()] in (
            [], ["finished_tracking"])
        aud.heal()
        assert aud.audit() == []
        assert set(store._admitted) == {
            k for k, w in store.workloads.items()
            if w.is_quota_reserved and not w.is_finished}
    finally:
        port_metrics.invariant_last_violations.set(value=gauge0)


def _audit_parity(played):
    import time

    out = {}
    for pkg, manager, auditor in (("jax", JaxManager, JaxAuditor),
                                  ("port", PortManager, PortAuditor)):
        d, _ = played[(pkg, True)]
        store = manager(d).recover().store
        clean = [v.to_dict() for v in auditor(store).audit()]
        held = sorted(store._admitted)
        store._admitted.pop(held[0])
        store._finished_counted.add(held[1])
        wl = store.workloads[held[2]]
        wl.status.admission.podset_assignments[0].name = "renamed"
        found = [v.to_dict() for v in auditor(store).audit()]
        a = auditor(store, auto_heal=True)
        after = [v.to_dict() for v in a.audit()]
        bg = auditor(store)
        bg.start(interval_s=0.01)
        deadline = time.monotonic() + 10
        while bg.audits_run == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        bg.stop()
        out[pkg] = (clean, found, after, a.heals_run, bg.audits_run > 0)
    assert out["port"][0] == []
    assert {v["check"] for v in out["port"][1]} >= {
        "admitted_index", "finished_tracking", "podset_mismatch"}
    # the heal rebuilds the indexes; the spec divergence stays reported
    assert "admitted_index" not in {v["check"] for v in out["port"][2]}
    assert "podset_mismatch" in {v["check"] for v in out["port"][2]}
    assert out["port"][3] == 1
    assert out["port"] == out["jax"]


def test_log_shipping_and_warm_standby(tmp_path):
    """Shipping the harness's scenario (incremental checkpoints on): the
    standby directories hold the same bytes in both packages, and each
    promoted standby is the primary's own recovery, byte for byte."""
    out = {}
    for pkg, manager, standby, codec in (
            ("jax", JaxManager, JaxStandby, jax_codec),
            ("port", PortManager, PortStandby, port_codec)):
        d, ship = str(tmp_path / pkg), str(tmp_path / f"{pkg}-ship")
        store, m, _ = _play(pkg, d, False, fsync="batch", ship_to=ship,
                            incremental=True, full_checkpoint_every=2)
        sb = standby(ship)
        mid = sb.catch_up()
        m.checkpoint()
        m.close()
        promoted, tail = sb.promote()
        recovered = manager(d).recover().store
        assert codec.canonical_dump(promoted) == codec.canonical_dump(
            recovered) == codec.canonical_dump(store)
        out[pkg] = (_files(ship), mid, tail, sb.records_applied,
                    m.shipper.shipped_bytes, codec.canonical_dump(promoted))
    assert out["port"] == out["jax"]


def _crashtest(pkg, d, phase, solver, env=None):
    mod = ("kueue_oss_tpu_torch" if pkg == "port" else "kueue_oss_tpu")
    cmd = [sys.executable, "-m", f"{mod}.persist.crashtest", "--dir", d,
           "--phase", phase]
    if solver:
        cmd.append("--solver")
    if pkg == "port":
        cmd += ["--device", "cpu"]
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(cmd, cwd=ROOT, env=full_env, capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def jax_baselines(tmp_path_factory):
    out = {}
    for solver in (False, True):
        d = str(tmp_path_factory.mktemp(f"jaxbase{int(solver)}"))
        proc = _crashtest("jax", d, "run", solver)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[solver] = Path(d, "final.dump").read_bytes()
    return out


@pytest.mark.parametrize("point,after,solver", [
    ("pre_fsync", 12, False), ("torn_tail", 20, False),
    ("post_fsync_pre_apply", 6, False), ("mid_checkpoint", 0, False),
    ("mid_drain", 2, True)])
def test_crash_point_recovers_to_the_jax_dump(jax_baselines, tmp_path,
                                              point, after, solver):
    from kueue_oss_tpu_torch.chaos import CrashPointInjector

    d = str(tmp_path)
    env = CrashPointInjector(point, after=after).env()
    crashed = _crashtest("port", d, "run", solver, env)
    assert crashed.returncode == -9, (crashed.returncode,
                                      crashed.stderr[-2000:])
    assert not os.path.exists(os.path.join(d, "final.dump"))
    rec = _crashtest("port", d, "recover", solver)
    assert rec.returncode == 0, rec.stderr[-2000:]
    status = json.loads(rec.stdout.strip().splitlines()[-1])
    assert status["completed"] and status["audit_violations"] == []
    assert Path(d, "final.dump").read_bytes() == jax_baselines[solver]
    if point in ("torn_tail",):
        assert status["torn_tail"]
    if solver:
        # the recovered run's drains were served on the device: no local
        # solve fault moved them to host cycles
        assert status["session_first_frame_sync"]
        assert status["device_error"] == 0
        assert status["drains_by_arm"].get("single", 0) >= 1


def test_solver_baseline_is_the_jax_dump_and_the_chip_smoke_pin(
        jax_baselines, tmp_path):
    """The port's --solver no-crash run drains on the device (no
    device_error, at least one drain served by the single arm) to the
    JAX harness's dump, whose sha256 and size are chip_smoke.py's
    PERSIST_REFERENCE["crash_solver"] (phase 24 (c))."""
    import hashlib

    import chip_smoke

    proc = _crashtest("port", str(tmp_path), "run", True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    status = json.loads(proc.stdout.strip().splitlines()[-1])
    assert status["device_error"] == 0
    assert status["drains_by_arm"].get("single", 0) >= 1
    assert status["audit_violations"] == []
    dump = Path(tmp_path, "final.dump").read_bytes()
    assert dump == jax_baselines[True]
    ref = chip_smoke.PERSIST_REFERENCE["crash_solver"]
    assert {"bytes": len(dump),
            "sha256": hashlib.sha256(dump).hexdigest()} == ref


def test_crash_harness_refuses_a_missing_card(tmp_path):
    """Without CUDA the harness's default device raises: no fallback
    hides the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, "-m", "kueue_oss_tpu_torch.persist.crashtest",
         "--dir", str(tmp_path), "--phase", "run"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not os.path.exists(tmp_path / "final.dump")


def test_seeded_codec_round_trip():
    """Seeded random workloads (numpy) encode to the JAX bytes and decode
    back exactly in the port."""
    rng = np.random.default_rng(3)
    for i in range(20):
        kw = dict(name=f"w{i}", queue_name="lq", uid=int(rng.integers(1e6)),
                  priority=int(rng.integers(-5, 5)),
                  creation_time=float(rng.random()),
                  podsets=[dict(name=f"p{j}", count=int(rng.integers(1, 4)),
                                requests={"cpu": int(rng.integers(1, 9))})
                           for j in range(int(rng.integers(1, 3)))])
        objs = []
        for types in (jax_types, port_types):
            k = dict(kw, podsets=[types.PodSet(**p) for p in kw["podsets"]])
            wl = types.Workload(**k)
            wl.set_condition(types.WorkloadConditionType.QUOTA_RESERVED,
                             True, reason="QuotaReserved", now=2.0)
            objs.append(wl)
        jd, pd = jax_codec.to_dict(objs[0]), port_codec.to_dict(objs[1])
        assert jax_codec.canonical_json(jd) == port_codec.canonical_json(pd)
        back = port_codec.from_dict("Workload", jd)
        assert port_codec.to_dict(back) == pd


def _port_durable():
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.persist import (
        InvariantAuditor,
        PersistenceManager,
        canonical_dump,
    )
    from kueue_oss_tpu_torch.scenarios import Durable
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    return Durable(port_types, Store, QueueManager, Scheduler, SolverEngine,
                   PersistenceManager, InvariantAuditor, canonical_dump,
                   sched_kw={"device": "cpu"}, engine_kw={"device": "cpu"},
                   engine_attrs={"relax_enabled": False})


def _durable_record(out):
    # the obs rings a recovery restores are each package's process-wide
    # journal and ledger, not durable state: their counts stay out
    rec = {k: v for k, v in out["recovery"].items()
           if k not in ("journal_events_restored", "ledger_rows_restored")}
    return ([(r.admitted, r.evicted, r.rounds) for r, _ in out["drains"]]
            if "drains" in out else out["cycles"],
            {k: v for k, v in out.items()
             if k not in ("drains", "drain", "sched", "store", "recovery",
                          "checkpoint_ms", "recovery_ms", "wall_s")}, rec)


def test_durable_runs_match(tmp_path):
    """chip_smoke.py phase 24's durable storm (at a twentieth of one
    cohort) and durable TAS drain (60 workloads) write the JAX
    package's WAL bytes and end in its dump, recovered byte for byte."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_persist_pins import jax_durable

    from kueue_oss_tpu_torch.scenarios import durable_storm, durable_tas

    small = dict(n_cohorts=1, cqs_per_cohort=2, scale=0.05)
    got = {}
    for name, pkg in (("jax", jax_durable()), ("port", _port_durable())):
        storm = durable_storm(pkg, str(tmp_path / f"s{name}"), **small)
        tas = durable_tas(pkg, str(tmp_path / f"t{name}"), n_workloads=60)
        got[name] = (_durable_record(storm), _durable_record(tas))
    storm_rec = got["port"][0][1]
    assert storm_rec["recovered_identical"]
    assert storm_rec["audit_violations"] == 0
    assert got["port"][0][2]["checkpoint_id"] == 1
    assert got["port"][1][1]["recovered_identical"]
    assert got["port"] == got["jax"]
