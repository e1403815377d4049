"""The port's engine with delta sessions on (its default) against the
JAX engine with sessions on (``mesh_mode="off"``), tolerance 0, over a
finish-and-arrive churn cycle (``scenarios.StormChurn``).

Identical stores of both packages: a lean store, the reduced TAS drain
store, the baseline preemption storm (2 cohorts x 3 ClusterQueues,
class counts x 0.1, both waves and all ten churn cycles of
``scenarios.storm_churn_drains``), the fair reclamation storm and the
AFS backlog (one cohort each), every one with at least three churn
cycles. Per drain: the admitted keys in order, the evicted keys in
order, rounds, flavors, victims' Preempted reasons, topology
assignments, the queues' heap and parked sets, and the session's frame
(kind, ``full_reason``, checksum) and slotted problem, field by field.

A second test holds the port with sessions on against itself with
sessions off: the same decisions per drain (admitted and evicted sets,
flavors, reasons), rows in either order.

Run as a script, ``JAX_PLATFORMS=cpu python
tests/test_torch_engine_sessions.py``, it prints the JAX engine's plans
of chip_smoke.py's phase 10 (the full-size storm under churn, sessions
on) in the form chip_smoke.py pins them.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import collections
import json
import sys

import numpy as np

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.afs import AfsManager as JaxAfs
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.afs import AfsManager as PortAfs
from kueue_oss_tpu_torch.core.eviction import finish_workload
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scenarios import (
    StormChurn,
    afs_baseline_store,
    baseline_preempt_store,
    fair_reclaim_store,
    preempt_plan_digest,
    preempt_plan_rows,
    storm_churn_drains,
    tas_drain_store,
)
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine


def _lean_store(types, store_cls):
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(4):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", cohort="co" if i < 2 else None,
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=6)])])]))
        store.upsert_local_queue(types.LocalQueue(name=f"lq{i}",
                                                  cluster_queue=f"cq{i}"))
    for i in range(60):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            priority=i % 3, creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1 + i % 2})]))
    return store


class _Side:
    """One package's engine, its finish path and the frames its
    sessions emitted."""

    def __init__(self, port: bool, store, afs=None, fs=False,
                 sessions=True):
        self.port, self.store = port, store
        if port:
            self.queues = PortQueues(store, afs=afs)
            self.engine = PortEngine(store, self.queues, device="cpu",
                                     enable_fair_sharing=fs)
        else:
            self.queues = JaxQueues(store, afs=afs)
            self.sched = JaxScheduler(store, self.queues)
            self.engine = JaxEngine(store, self.queues,
                                    scheduler=self.sched,
                                    enable_fair_sharing=fs,
                                    mesh_mode="off")
        self.engine.use_sessions = sessions
        # the relaxed arm routes by wall clock: pinned off on both sides
        self.engine.relax_enabled = False
        self.encoded = []
        real = self.engine._session_encode

        def record(*args, **kw):
            out = real(*args, **kw)
            self.encoded.append(out)
            return out
        self.engine._session_encode = record

    def finish(self, key, now):
        if self.port:
            finish_workload(self.store, self.queues, key, now)
        else:
            self.sched.finish_workload(key, now=now)

    def heap_and_parked(self):
        heap = "_in_heap"
        return {name: (sorted(getattr(q, heap)), sorted(q.inadmissible))
                for name, q in self.queues.queues.items()}


def _topologies(store, keys):
    out = []
    for key in keys:
        for psa in store.workloads[key].status.admission.podset_assignments:
            ta = psa.topology_assignment
            out.append(None if ta is None else
                       (ta.levels, [(d.values, d.count) for d in ta.domains]))
    return out


def _compare(sides, now, label):
    """Drain both engines at ``now``; everything must agree."""
    jside, pside = sides
    want = jside.engine.drain(now=now)
    got = pside.engine.drain(now=now)
    assert got.admitted_keys == want.admitted_keys, label
    assert got.evicted_keys == want.evicted_keys, label
    assert (got.admitted, got.evicted, got.rounds) == (
        want.admitted, want.evicted, want.rounds), label
    assert preempt_plan_rows(pside.store, got) == preempt_plan_rows(
        jside.store, want), label
    assert _topologies(pside.store, got.admitted_keys) == _topologies(
        jside.store, want.admitted_keys), label
    assert pside.heap_and_parked() == jside.heap_and_parked(), label
    assert len(jside.encoded) == len(pside.encoded), label
    if jside.encoded:
        (js, jf), (ps, pf) = jside.encoded[-1], pside.encoded[-1]
        assert pf is got.frame and pf is not None, label
        assert (pf.epoch, pf.checksum, pf.full_reason) == (
            jf.epoch, jf.checksum, jf.full_reason), label
        assert (pf.delta is None) == (jf.delta is None), label
        if pf.delta is not None:
            assert pf.delta.payload_bytes() == jf.delta.payload_bytes()
        for name in js.__dataclass_fields__:
            w, g = getattr(js, name), getattr(ps, name)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, (label, name)
                np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
            else:
                assert g == w, (label, name)
    return want, got


def _churn(sides, types_pair, n, cycles, t0):
    churns = [StormChurn(t, s.store, n, t0=t0)
              for t, s in zip(types_pair, sides)]
    for c in range(1, cycles + 1):
        nows = {ch.cycle(c, side.finish) for ch, side in zip(churns, sides)}
        yield nows.pop()


TYPES = (jax_types, port_types)


def _kinds(result_frames):
    return ["delta" if f.delta is not None else f.full_reason
            for f in result_frames]


def test_lean_store_under_churn_matches_jax():
    sides = tuple(_Side(port, _lean_store(t, s))
                  for port, t, s in ((False, jax_types, JaxStore),
                                     (True, port_types, PortStore)))
    for side in sides:
        side.engine.pad_to = 256
    _compare(sides, 1.0, "first")
    admitted = 0
    for now in _churn(sides, TYPES, 3, 4, 1.0):
        _, got = _compare(sides, now, f"t={now}")
        admitted += got.admitted
    assert admitted > 0, "vacuous: the churn admitted nothing"
    frames = _kinds(f for _, f in sides[1].encoded)
    assert frames[0] == "first_sync" and "delta" in frames, frames
    assert got.full_stats is None, "the lean drain ran"


def test_tas_store_under_churn_matches_jax():
    kw = dict(n_racks=4, n_hosts=8, n_cohorts=2, n_cqs=3, n_workloads=300)
    sides = (_Side(False, tas_drain_store(jax_types, JaxStore, **kw)),
             _Side(True, tas_drain_store(port_types, PortStore, **kw)))
    _, first = _compare(sides, 0.0, "first")
    assert first.admitted > 0 and "placement" in first.phases
    for now in _churn(sides, TYPES, 4, 3, 0.0):
        _compare(sides, now, f"t={now}")
    assert "delta" in _kinds(f for _, f in sides[1].encoded)


def test_storm_under_churn_matches_jax():
    kw = dict(n_cohorts=2, cqs_per_cohort=3, scale=0.1)
    built = [baseline_preempt_store(t, s, **kw)
             for t, s in ((jax_types, JaxStore), (port_types, PortStore))]
    sides = tuple(_Side(port, b[0]) for port, b in zip((False, True), built))
    steps = [storm_churn_drains(t, b[0], b[1], b[2], side.finish)
             for t, b, side in zip(TYPES, built, sides)]
    evicted = 0
    for (label, now), other in zip(*steps):
        assert other == (label, now)
        _, got = _compare(sides, now, label)
        evicted += got.evicted
        assert got.export_stats, "the columnar view served the export"
    assert evicted >= 120
    kinds = _kinds(f for _, f in sides[1].encoded)
    assert len(kinds) == 12 and kinds[0] == "first_sync"
    assert kinds.count("delta") >= 5, kinds


def test_storm_light_churn_reaches_scatter_like_jax():
    """chip_smoke.py phase 10's light churn after the heavy one: cycles
    that lower the priority of the newest 0.5% of the pending workloads
    in place. The backlog's membership stays, so from the second cycle
    the columnar export scatters the dirty rows, the session emits a
    delta through its hint advance, and every plan and frame equals the
    JAX engine's."""
    import chip_smoke

    kw = dict(n_cohorts=2, cqs_per_cohort=3, scale=0.1)
    built = [baseline_preempt_store(t, s, **kw)
             for t, s in ((jax_types, JaxStore), (port_types, PortStore))]
    sides = tuple(_Side(port, b[0]) for port, b in zip((False, True), built))
    steps = [storm_churn_drains(t, b[0], b[1], b[2], side.finish)
             for t, b, side in zip(TYPES, built, sides)]
    for (label, now), _ in zip(*steps):
        _compare(sides, now, label)
    session = sides[1].engine._delta_sessions["full"]
    modes, advances = [], []
    for c in range(1, chip_smoke.LIGHT_CYCLES + 1):
        edited = [chip_smoke.light_churn_edit(side.store) for side in sides]
        assert edited[0] == edited[1] >= 1
        fast0 = session.fast_advances
        _, got = _compare(sides, now + c, f"light{c}")
        modes.append(got.export_stats["export_mode"])
        advances.append(session.fast_advances - fast0)
    kinds = _kinds(f for _, f in sides[1].encoded)[-chip_smoke.LIGHT_CYCLES:]
    assert modes[1:] == ["scatter"] * (chip_smoke.LIGHT_CYCLES - 1), modes
    assert kinds[1:] == ["delta"] * (chip_smoke.LIGHT_CYCLES - 1), kinds
    assert advances[1:] == [1] * (chip_smoke.LIGHT_CYCLES - 1), advances


def test_fair_storm_under_churn_matches_jax():
    kw = dict(n_cohorts=1, cqs_per_cohort=6, scale=0.3)
    built = [fair_reclaim_store(t, s, **kw)
             for t, s in ((jax_types, JaxStore), (port_types, PortStore))]
    sides = tuple(_Side(port, b[0], fs=True)
                  for port, b in zip((False, True), built))
    for wave, now in ((1, 100.0), (2, 200.0)):
        for b, side in zip(built, sides):
            for wl in b[wave]:
                side.store.add_workload(wl)
        _compare(sides, now, f"wave{wave}")
        if wave == 2:
            assert _preempted_reasons(sides[1].store) == {
                "InCohortReclamation", "InCohortFairSharing"}
    for now in _churn(sides, TYPES, 2, 3, 200.0):
        _compare(sides, now, f"t={now}")
    assert "delta" in _kinds(f for _, f in sides[1].encoded)


def test_afs_backlog_under_churn_matches_jax():
    kw = dict(n_cohorts=1, cqs_per_cohort=3, scale=0.1)
    built = [afs_baseline_store(t, s, a, **kw)
             for t, s, a in ((jax_types, JaxStore, JaxAfs),
                             (port_types, PortStore, PortAfs))]
    sides = tuple(_Side(port, b[0], afs=b[1])
                  for port, b in zip((False, True), built))
    for b, side in zip(built, sides):
        for wl in b[2]:
            side.store.add_workload(wl)
    _, first = _compare(sides, 60.0, "backlog")
    assert first.admitted > 0
    for now in _churn(sides, TYPES, 2, 3, 60.0):
        _compare(sides, now, f"t={now}")
    frames = _kinds(f for _, f in sides[1].encoded)
    assert frames[0] == "first_sync" and len(frames) == 4


def _preempted_reasons(store):
    return {w.status.conditions["Preempted"].reason
            for w in store.workloads.values()
            if "Preempted" in w.status.conditions}


def _decisions(store, result):
    adm = {k: (store.workloads[k].status.admission.cluster_queue,
               [sorted(p.flavors.items()) for p in
                store.workloads[k].status.admission.podset_assignments])
           for k in result.admitted_keys}
    ev = {k: store.workloads[k].status.conditions["Preempted"].reason
          for k in result.evicted_keys}
    return adm, ev


def test_port_sessions_on_and_off_reach_the_same_decisions():
    kw = dict(n_cohorts=2, cqs_per_cohort=3, scale=0.1)
    built = [baseline_preempt_store(port_types, PortStore, **kw)
             for _ in range(2)]
    sides = tuple(_Side(True, b[0], sessions=on)
                  for on, b in zip((True, False), built))
    steps = [storm_churn_drains(port_types, b[0], b[1], b[2], side.finish)
             for b, side in zip(built, sides)]
    for (label, now), _ in zip(*steps):
        on = sides[0].engine.drain(now=now)
        off = sides[1].engine.drain(now=now)
        assert _decisions(sides[0].store, on) == _decisions(
            sides[1].store, off), label
        assert on.rounds == off.rounds, label
        assert off.frame is None and on.frame is not None
        assert off.device["full_uploads"] == 1
    assert all(frame is None for _, frame in sides[1].encoded)
    assert sides[1].engine._device_states == {}


def _reference_plans() -> list:
    """The JAX engine's plans of chip_smoke.py's phase 10 at full size
    (sessions on, no mesh): per drain the label, the drain time, counts,
    rounds, the workloads holding quota after it, the plan digest, the
    victims' reasons and the session frame's kind."""
    store, wave1, wave2 = baseline_preempt_store(jax_types, JaxStore)
    side = _Side(False, store)
    out = []
    for label, now in storm_churn_drains(jax_types, store, wave1, wave2,
                                         side.finish):
        result = side.engine.drain(now=now)
        frame = side.encoded[-1][1]
        out.append({
            "label": label, "now": now, "admitted": result.admitted,
            "evicted": result.evicted, "rounds": result.rounds,
            "held": sum(1 for w in store.workloads.values()
                        if w.is_quota_reserved),
            "digest": preempt_plan_digest(store, result),
            "reasons": dict(sorted(collections.Counter(
                store.workloads[k].status.conditions["Preempted"].reason
                for k in result.evicted_keys).items())),
            "frame": ("delta" if frame.delta is not None
                      else frame.full_reason)})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(_reference_plans(), indent=1))
