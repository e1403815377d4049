"""The port's columnar export (kueue_oss_tpu_torch/solver/columnar.py)
against its own classic walk and against the JAX package's columnar
export, tolerance 0 (after tests/test_columnar.py).

- Random event batches (arrivals, touches, priority / timestamp /
  request edits, deletions, quota edits, node flaps) on identical
  stores of both packages: after every batch the port's columnar export
  must equal the port's classic walk on the same ``ExportCache`` field
  by field, and the JAX package's columnar export, with the same
  ``ColumnarHint`` (mode, membership flag, changed-row positions).
- Each path on purpose: ``cached`` (no change), ``scatter`` (content
  only), ``assemble`` (a workload joins), ``rebuild`` (a quota edit),
  and the AFS bail-out to the classic walk (counted in ``bailouts``).
- The delta session's hint fast path: ``HostDeltaSession.advance`` with
  the columnar hint must give the classic advance's slotted problem and
  JAX's, and its frames must replay a mirror of the encoding.
"""

import copy
import dataclasses
import random

import numpy as np
import pytest

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.afs import AfsManager as JaxAfs
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver import delta as jax_delta
from kueue_oss_tpu.solver import tensors as jax_tensors
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.afs import AfsManager as PortAfs
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.solver import delta as port_delta
from kueue_oss_tpu_torch.solver import tensors as port_tensors

PORT = (port_types, PortStore, PortQueues, port_tensors, port_delta)
JAX = (jax_types, JaxStore, JaxQueues, jax_tensors, jax_delta)


def make_cq(types, name, nominal, cohort=None, bl=None, flavors=None):
    fqs = flavors or [types.FlavorQuotas(name="default", resources=[
        types.ResourceQuota(name="cpu", nominal=nominal,
                            borrowing_limit=bl)])]
    return types.ClusterQueue(
        name=name, cohort=cohort,
        resource_groups=[types.ResourceGroup(
            covered_resources=["cpu"], flavors=fqs)],
        queueing_strategy=types.QueueingStrategy.BEST_EFFORT_FIFO,
        preemption=types.PreemptionPolicy())


def build_store(types, store_cls):
    store = store_cls()
    for f in ("default", "small", "large"):
        store.upsert_resource_flavor(types.ResourceFlavor(name=f))
    store.upsert_node(types.Node(name="n1", allocatable={"cpu": 100000}))
    store.upsert_cohort(types.Cohort(name="co"))
    rq = types.ResourceQuota
    for cq in (make_cq(types, "a", 2000, cohort="co"),
               make_cq(types, "b", 1000, cohort="co", bl=0),
               make_cq(types, "c", 3000),
               make_cq(types, "m", 0, flavors=[
                   types.FlavorQuotas(name="small", resources=[
                       rq(name="cpu", nominal=1500)]),
                   types.FlavorQuotas(name="large", resources=[
                       rq(name="cpu", nominal=4000)])])):
        store.upsert_cluster_queue(cq)
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq-{cq.name}", cluster_queue=cq.name))
    return store


class _Env:
    """One package's store, queues and export cache."""

    def __init__(self, pkg):
        (self.types, store_cls, queues_cls, self.T, self.D) = pkg
        self.store = build_store(self.types, store_cls)
        self.qm = queues_cls(self.store)
        self.cache = self.T.ExportCache(self.store)
        assert self.cache.columnar is not None

    def submit(self, name, cq, t, uid, cpu=500, prio=0):
        self.store.add_workload(self.types.Workload(
            name=name, queue_name=f"lq-{cq}", priority=prio,
            creation_time=t, uid=uid,
            podsets=[self.types.PodSet(count=1, requests={"cpu": cpu})]))

    def backlog(self):
        return {name: q.snapshot_order()
                for name, q in sorted(self.qm.queues.items())}

    def export(self, **kw):
        return self.T.export_problem(self.store, self.backlog(),
                                     cache=self.cache, now=1.0, **kw)


def assert_problems_equal(want, got, label):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, (label, f.name, a.dtype, b.dtype)
            assert a.shape == b.shape, (label, f.name, a.shape, b.shape)
            assert np.array_equal(a, b), (label, f.name)
        else:
            assert a == b, (label, f.name, a, b)


def assert_hints_equal(want, got, label):
    assert (want is None) == (got is None), label
    if want is None:
        return
    for slot in ("seq", "base_seq", "membership_changed", "changed",
                 "mode", "n_workloads"):
        assert getattr(got, slot) == getattr(want, slot), (label, slot)


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_columnar_matches_classic_and_jax_under_churn(seed):
    rng = random.Random(seed)
    envs = (_Env(JAX), _Env(PORT))
    uid = [100]
    live = []

    def both(fn):
        for env in envs:
            fn(env)

    def arrival(prio=0):
        uid[0] += 1
        u = uid[0]
        cq = rng.choice("abcm")
        both(lambda e: e.submit(f"w{u}", cq, float(u), u,
                                cpu=100 * (1 + u % 4), prio=prio))
        live.append(f"default/w{u}")

    for _ in range(16):
        arrival()

    def edit(mutate):
        if live:
            key = rng.choice(live)
            value = mutate()

            def apply(e):
                wl = e.store.workloads[key]
                if value is not None:
                    value[0](wl, value[1])
                e.store.update_workload(wl)
            both(apply)

    def set_prio(wl, v):
        wl.priority = v

    def set_ts(wl, v):
        wl.creation_time = v

    def set_req(wl, v):
        wl.podsets[0].requests["cpu"] = v

    def finish():
        if len(live) > 4:
            key = live.pop(rng.randrange(len(live)))
            both(lambda e: e.store.delete_workload(key))

    def quota_edit():
        nominal = rng.choice([1800, 2000, 2400])
        both(lambda e: e.store.upsert_cluster_queue(
            make_cq(e.types, "a", nominal, cohort="co")))

    def node_flap():
        cpu = rng.choice([80000, 100000])
        both(lambda e: e.store.upsert_node(
            e.types.Node(name="n1", allocatable={"cpu": cpu})))

    ops = [lambda: arrival(rng.choice([0, 0, 3])),
           lambda: arrival(rng.choice([0, 0, 3])),
           lambda: edit(lambda: None),
           lambda: edit(lambda: (set_prio, rng.randint(0, 5))),
           lambda: edit(lambda: (set_ts, rng.uniform(0.0, 500.0))),
           lambda: edit(lambda: (set_req, rng.choice([100, 250, 400,
                                                      900]))),
           finish, quota_edit, node_flap]
    modes = set()
    for batch in range(25):
        for _ in range(rng.randint(0, 4)):
            rng.choice(ops)()
        label = f"seed{seed}/b{batch}"
        jcol = envs[0].export()
        pcol = envs[1].export()
        hint = getattr(pcol, "_columnar_hint", None)
        assert_hints_equal(getattr(jcol, "_columnar_hint", None), hint,
                           label)
        if hint is not None:
            modes.add(hint.mode)
        classic = envs[1].export(columnar=False)
        assert_problems_equal(classic, pcol, label)
        assert_problems_equal(jcol, pcol, label)
    assert "cached" in modes or "scatter" in modes, modes


def test_each_columnar_path_and_the_afs_bailout():
    envs = (_Env(JAX), _Env(PORT))
    for i in range(12):
        for env in envs:
            env.submit(f"wl-{i}", "abcm"[i % 4], float(i), 1000 + i,
                       cpu=100 + (i % 3) * 50, prio=i % 2)

    def step(mutate=None):
        out = []
        for env in envs:
            if mutate is not None:
                mutate(env)
            out.append(env.export())
        jcol, pcol = out
        assert_hints_equal(jcol._columnar_hint, pcol._columnar_hint, "step")
        assert_problems_equal(jcol, pcol, pcol._columnar_hint.mode)
        assert_problems_equal(envs[1].export(columnar=False), pcol,
                              pcol._columnar_hint.mode)
        return pcol._columnar_hint

    assert step().mode == "rebuild"
    assert step().mode == "cached"

    def touch(env):
        wl = env.store.workloads["default/wl-3"]
        wl.priority = 7
        env.store.update_workload(wl)
    hint = step(touch)
    assert hint.mode == "scatter" and not hint.membership_changed
    assert hint.changed == {"default/wl-3": hint.changed["default/wl-3"]}
    assert step(lambda e: e.submit("wl-new", "a", 99.0, 9999,
                                   cpu=200)).mode == "assemble"
    assert step(lambda e: e.store.upsert_cluster_queue(
        make_cq(e.types, "c", 2600))).mode == "rebuild"

    # admission fair sharing: the view bails to the classic walk
    for env, afs_cls in zip(envs, (JaxAfs, PortAfs)):
        cq = env.store.cluster_queues["a"]
        cq.admission_scope = env.types.AdmissionScope()
        env.store.upsert_cluster_queue(cq)
        env.afs = afs_cls()
        env.afs.record_admission("default/lq-a", {"cpu": 300}, 0.0)
    jp, pp = (env.T.export_problem(env.store, env.backlog(),
                                   cache=env.cache, now=1.0, afs=env.afs)
              for env in envs)
    col = envs[1].cache.columnar
    assert col.last_stats["mode"] == "bailout:afs_active"
    assert col.bailouts == {"afs_active": 1}
    assert not hasattr(pp, "_columnar_hint")
    assert pp.cq_afs.any()
    assert_problems_equal(jp, pp, "afs")


def test_hint_advance_matches_classic_and_jax_and_replays():
    envs = (_Env(JAX), _Env(PORT))
    for i in range(12):
        for env in envs:
            env.submit(f"wl-{i}", "abcm"[i % 4], float(i), 1000 + i,
                       cpu=100 + (i % 3) * 50, prio=i % 2)
    fast = [env.D.HostDeltaSession(cache=env.cache) for env in envs]
    classic = port_delta.HostDeltaSession(cache=None)
    mirror = {}

    def step(label, mutate=None):
        slotted = []
        for env, sess in zip(envs, fast):
            if mutate is not None:
                mutate(env)
            prob = env.export()
            padded = env.T.pad_workloads(prob, 32)
            if env is envs[1]:
                twin = dataclasses.replace(padded, **{
                    f.name: (np.array(getattr(padded, f.name))
                             if isinstance(getattr(padded, f.name),
                                           np.ndarray)
                             else copy.deepcopy(getattr(padded, f.name)))
                    for f in dataclasses.fields(padded)})
            slotted.append(sess.advance(padded,
                                        hint=prob._columnar_hint))
        (js, jf), (sa, fa) = slotted
        sb, fb = classic.advance(twin)
        assert_problems_equal(sb, sa, label)
        assert_problems_equal(js, sa, label)
        assert (fa.delta is None) == (jf.delta is None), label
        assert fa.full_reason == jf.full_reason, label
        if fa.delta is None:
            kw, meta = port_delta.problem_wire_state(sa)
            mirror["kw"] = copy.deepcopy(kw)
            mirror["meta"] = dict(meta)
        else:
            assert fa.checksum == jf.checksum, label
            port_delta.apply_delta(mirror["kw"], mirror["meta"], fa.delta)
            kb, mb = port_delta.problem_wire_state(sb)
            for name, arr in kb.items():
                if arr is not None:
                    assert np.array_equal(mirror["kw"][name], arr), (
                        label, name)
            assert mirror["meta"] == mb, label

    step("first")
    step("unchanged")
    step("touch", lambda e: e.store.update_workload(
        e.store.workloads["default/wl-3"]))
    step("unchanged2")

    def prio(env):
        wl = env.store.workloads["default/wl-5"]
        wl.priority = 9
        env.store.update_workload(wl)
    step("prio", prio)
    step("arrival", lambda e: e.submit("wl-new", "a", 99.0, 9999, cpu=200))
    step("unchanged3")

    def ts(env):
        wl = env.store.workloads["default/wl-7"]
        wl.creation_time = 55.5
        env.store.update_workload(wl)
    step("ts", ts)
    step("unchanged4")
    assert fast[1].fast_advances == fast[0].fast_advances >= 3
