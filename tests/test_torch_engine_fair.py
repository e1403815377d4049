"""The port's fair-sharing and admission-fair-sharing (AFS) drains end to
end on the CPU against the JAX engine (``mesh_mode="off"``, delta
sessions on in both engines, their default; the storm and the AFS
backlog also with both off), tolerance 0.

Identical stores come from one builder per case, parameterised by the
types module. The port has no host scheduler, so both phases of a
scenario are drained by the engines:

- ``fs_scenario``: the shapes of tests/test_fair_parity.py's
  ``build_fs_scenario`` (one cohort or a two-level cohort tree, random
  quotas, borrowing and lending limits, preemption policies) with fair
  weights drawn from {0, 0.5, 1, 2} on ClusterQueues and cohorts, a
  ClusterQueue beside two cohorts in the two-level tree, memory beside
  cpu in some seeds, and a parentless ClusterQueue that preempts within
  itself. Eight seeds share one store as disjoint trees, so that one
  JAX compile serves each phase;
- the fair reclamation storm (``scenarios.fair_reclaim_store``) at one
  cohort: 120 smalls admitted, then 2 reclaimers evict 40 of them, 20
  ``InCohortReclamation`` and 20 ``InCohortFairSharing`` victims;
- the AFS baseline backlog (``scenarios.afs_baseline_store``) at one
  cohort, and tests/test_afs.py's lighter-queue-first and
  alternating-penalty drains;
- a TAS store with preemption under fair sharing (the sequential
  placer's plain version on the fair path).

Per drain: the admitted keys in order, the evicted keys, the flavors,
the rounds, every workload's conditions (Preempted reasons included),
the queues' heap and parked sets (``_check_drain``). The host DRS of the
port's ``core/quota.py`` is held against the JAX package's (exactly)
and against the port's device ``drs_all`` on the same usage.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import collections
import random

import numpy as np
import pytest
from test_torch_engine_full import _check_drain

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core import quota as jax_quota
from kueue_oss_tpu.core.afs import AfsManager as JaxAfs
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.snapshot import build_snapshot as jax_snapshot
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.convert import full_tensors_from_arrays
from kueue_oss_tpu_torch.core import quota as port_quota
from kueue_oss_tpu_torch.core.afs import AfsManager as PortAfs
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scenarios import (
    afs_baseline_store,
    fair_reclaim_store,
    plan_rows,
    tas_drain_store,
)
from kueue_oss_tpu_torch.solver import fair_kernels as pfair
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.full_kernels import host_tensors_full
from kueue_oss_tpu_torch.solver.kernels import potential_available_all
from kueue_oss_tpu_torch.solver.tensors import export_problem, order_nodes

WEIGHTS = (0.0, 0.5, 1.0, 2.0)


def fs_store(types, store_cls, seed: int, uniform: bool = False):
    """``build_fs_scenario``'s shapes for either package: returns
    (store, phase1, phase2) with the workloads built, uids in order.
    See ``fs_scenario``."""
    store = store_cls()
    return (store, *fs_scenario(types, store, seed, uniform))


def fs_scenario(types, store, seed: int, uniform: bool = False,
                prefix: str = ""):
    """Add one ``build_fs_scenario`` tree to ``store``, every object
    name (and workload uid, by ``uid_base``) prefixed so that several
    seeds can share a store as disjoint cohort trees; returns (phase1,
    phase2).

    Odd seeds build a two-level tree: cohorts co0 and co1 under root,
    with cq3 directly under root beside them. Seeds with ``seed % 3 ==
    2`` cover memory beside cpu. Every scenario has a parentless
    ClusterQueue ``solo`` whose second phase preempts within it. With
    ``uniform`` every ClusterQueue has the same quota (no borrowing or
    lending limit) and every weight is 1, so shares tie."""
    rng = random.Random(20_000 + seed)
    uid_base = 100 * seed if prefix else 0

    def weight():
        w = rng.choice(WEIGHTS)
        return types.FairSharing(weight=1.0 if uniform else w)

    def n(name):
        return prefix + name

    store.upsert_resource_flavor(types.ResourceFlavor(name="f1"))
    if seed % 2:
        store.upsert_cohort(types.Cohort(name=n("root"),
                                         fair_sharing=weight()))
        for co in ("co0", "co1"):
            store.upsert_cohort(types.Cohort(name=n(co), parent=n("root"),
                                             fair_sharing=weight()))
        cohorts = ["co0", "co1", "co0", "root"]
    else:
        store.upsert_cohort(types.Cohort(name=n("co0")))
        cohorts = ["co0"] * 4
    resources = ["cpu", "memory"] if seed % 3 == 2 else ["cpu"]
    pv = types.PreemptionPolicyValue
    n_cqs = 4
    for c in range(n_cqs):
        quotas = []
        for r in resources:
            nominal = rng.choice([1000, 2000])
            borrowing = rng.choice([None, 1000, 2000])
            lending = rng.choice([None, 500])
            if uniform:
                nominal, borrowing, lending = 1000, None, None
            quotas.append(types.ResourceQuota(
                name=r, nominal=nominal, borrowing_limit=borrowing,
                lending_limit=lending))
        store.upsert_cluster_queue(types.ClusterQueue(
            name=n(f"cq{c}"), cohort=n(cohorts[c]), fair_sharing=weight(),
            preemption=types.PreemptionPolicy(
                within_cluster_queue=rng.choice(
                    [pv.NEVER, pv.LOWER_PRIORITY]),
                reclaim_within_cohort=rng.choice([pv.NEVER, pv.ANY])),
            resource_groups=[types.ResourceGroup(
                covered_resources=resources,
                flavors=[types.FlavorQuotas(name="f1",
                                            resources=quotas)])]))
        store.upsert_local_queue(types.LocalQueue(
            name=n(f"lq{c}"), cluster_queue=n(f"cq{c}")))
    store.upsert_cluster_queue(types.ClusterQueue(
        name=n("solo"),
        preemption=types.PreemptionPolicy(
            within_cluster_queue=pv.LOWER_PRIORITY),
        resource_groups=[types.ResourceGroup(
            covered_resources=resources,
            flavors=[types.FlavorQuotas(name="f1", resources=[
                types.ResourceQuota(name=r, nominal=1000)
                for r in resources])])]))
    store.upsert_local_queue(types.LocalQueue(name=n("lq-solo"),
                                              cluster_queue=n("solo")))

    def wl(uid, name, lq, prio, ts, cpu):
        requests = {"cpu": cpu}
        if len(resources) > 1:
            requests["memory"] = rng.choice([200, 700, 1500])
        return types.Workload(
            name=n(name), queue_name=n(lq), priority=prio,
            creation_time=ts, uid=uid_base + uid,
            podsets=[types.PodSet(name="main", count=1, requests=requests)])

    phase1, phase2 = [], []
    for i in range(rng.randint(3, 6)):
        phase1.append(wl(len(phase1) + 1, f"init{i}",
                         f"lq{rng.randrange(n_cqs)}", rng.randint(0, 2),
                         float(i), rng.choice([400, 700, 1000, 1500])))
    phase1.append(wl(len(phase1) + 1, "solo-low", "lq-solo", 0, 10.0, 700))
    for i in range(rng.randint(4, 10)):
        phase2.append(wl(len(phase1) + len(phase2) + 1, f"new{i}",
                         f"lq{rng.randrange(n_cqs)}", rng.randint(0, 3),
                         100.0 + i, rng.choice([400, 700, 1000, 1500, 2500])))
    phase2.append(wl(len(phase1) + len(phase2) + 1, "solo-high", "lq-solo",
                     5, 150.0, 700))
    return phase1, phase2


def _fair_engines(js, ps, jafs=None, pafs=None, fs=True, sessions=True):
    jq, pq = JaxQueues(js, afs=jafs), PortQueues(ps, afs=pafs)
    jengine = JaxEngine(js, jq, mesh_mode="off", enable_fair_sharing=fs)
    pengine = PortEngine(ps, pq, device="cpu", enable_fair_sharing=fs)
    # delta sessions on, both engines' default, or both off
    assert jengine.use_sessions and pengine.use_sessions
    jengine.use_sessions = pengine.use_sessions = sessions
    return ((js, jq, jengine), (ps, pq, pengine))


def _reasons(store, keys):
    return collections.Counter(
        store.workloads[k].status.conditions["Preempted"].reason
        for k in keys)


def _add(js, ps, jw, pw):
    for wl in jw:
        js.add_workload(wl)
    for wl in pw:
        ps.add_workload(wl)


def _host_drs_checks(js, ps, prefix=""):
    """The port's host DRS of every node (whose name starts with
    ``prefix``) against the JAX package's (exactly), and against the
    port's device ``drs_all`` on the export of the same store (float32
    against the host's float64: relative tolerance of one float32
    ulp)."""
    jforest = jax_snapshot(js).forest
    pforest = build_snapshot(ps).forest
    keys = [k for k, node in pforest.nodes.items()
            if node.name.startswith(prefix)]
    for key in keys:
        jd = jax_quota.dominant_resource_share(jforest.nodes[key])
        pd = port_quota.dominant_resource_share(pforest.nodes[key])
        assert ((pd.unweighted_ratio, pd.dominant_resource, pd.borrowing,
                 pd.borrowed_frs, pd.fair_weight, pd.precise_weighted_share(),
                 pd.rounded_weighted_share())
                == (jd.unweighted_ratio, jd.dominant_resource, jd.borrowing,
                    jd.borrowed_frs, jd.fair_weight,
                    jd.precise_weighted_share(),
                    jd.rounded_weighted_share())), key
    for a in keys:
        for b in keys:
            assert port_quota.compare_drs(
                port_quota.dominant_resource_share(pforest.nodes[a]),
                port_quota.dominant_resource_share(pforest.nodes[b])) == (
                jax_quota.compare_drs(
                    jax_quota.dominant_resource_share(jforest.nodes[a]),
                    jax_quota.dominant_resource_share(jforest.nodes[b])))
    assert port_quota.compare_drs(
        port_quota.negative_drs(), port_quota.DRS()) == -1

    problem = export_problem(ps, {}, include_admitted=True)
    t = full_tensors_from_arrays(host_tensors_full(problem), "cpu")
    lend = pfair.lendable_by_resource(t, potential_available_all(t))
    zwb, share, borrowing, unw = pfair.drs_all(t, t.usage0, lend)
    for i, node in enumerate(order_nodes(pforest)):
        if not node.name.startswith(prefix):
            continue
        d = port_quota.dominant_resource_share(node)
        assert bool(borrowing[i]) == d.borrowing, node.name
        assert bool(zwb[i]) == d._zero_weight_borrows, node.name
        np.testing.assert_allclose(float(unw[i]), d.unweighted_ratio,
                                   rtol=2 ** -23, err_msg=node.name)
        if node.fair_weight > 0:
            np.testing.assert_allclose(
                float(share[i]), d.precise_weighted_share(), rtol=2 ** -22,
                err_msg=node.name)


#: the fs_scenario seeds, drained together (``fs_drains``)
FS_SEEDS = range(8)


@pytest.fixture(scope="module")
def fs_drains():
    """Every ``FS_SEEDS`` scenario in one store, as disjoint cohort trees
    named ``s<seed>-...``, both phases drained by both engines and held
    equal by ``_check_drain`` (one JAX compile per phase, not one per
    seed and phase). Returns (JAX store, port store, [(want, got) per
    phase])."""
    js, ps = JaxStore(), PortStore()
    jw = [fs_scenario(jax_types, js, s, prefix=f"s{s}-") for s in FS_SEEDS]
    pw = [fs_scenario(port_types, ps, s, prefix=f"s{s}-") for s in FS_SEEDS]
    jax_side, port_side = _fair_engines(js, ps)
    results = []
    for phase, now in ((0, 50.0), (1, 200.0)):
        _add(js, ps, [w for p in jw for w in p[phase]],
             [w for p in pw for w in p[phase]])
        results.append(_check_drain(jax_side, port_side, now))
    return js, ps, results


@pytest.mark.parametrize("seed", FS_SEEDS)
def test_fair_scenarios_match_jax(fs_drains, seed):
    js, ps, results = fs_drains
    prefix = f"default/s{seed}-"
    for want, got in results:
        for attr in ("admitted_keys", "evicted_keys"):
            mine = [k for k in getattr(got, attr) if k.startswith(prefix)]
            assert mine == [k for k in getattr(want, attr)
                            if k.startswith(prefix)], attr
    assert any(k.startswith(prefix) for k in results[1][0].admitted_keys)
    _host_drs_checks(js, ps, f"s{seed}-")


def test_fair_scenarios_preempt_for_fair_shares(fs_drains):
    """The scenarios are not vacuous: their second phase evicts by fair
    sharing, by within-nominal reclamation and within a parentless
    ClusterQueue."""
    _, ps, results = fs_drains
    reasons = _reasons(ps, results[1][1].evicted_keys)
    assert reasons["InCohortFairSharing"] > 0, reasons
    assert reasons["InCohortReclamation"] > 0, reasons
    assert reasons["InClusterQueue"] > 0, reasons
    solo = {k for k in results[1][1].evicted_keys
            if ps.workloads[k].queue_name.endswith("-lq-solo")}
    assert solo, "no eviction in a parentless ClusterQueue"


def _fair_storm(sessions):
    js, jw1, jw2 = fair_reclaim_store(jax_types, JaxStore, n_cohorts=1)
    ps, pw1, pw2 = fair_reclaim_store(port_types, PortStore, n_cohorts=1)
    jax_side, port_side = _fair_engines(js, ps, sessions=sessions)
    _add(js, ps, jw1, pw1)
    want1, got1 = _check_drain(jax_side, port_side, 100.0)
    assert (got1.admitted, got1.evicted, got1.rounds) == (120, 0, 62)
    _add(js, ps, jw2, pw2)
    want2, got2 = _check_drain(jax_side, port_side, 200.0)
    assert (got2.admitted, got2.evicted, got2.rounds) == (2, 40, 7)
    assert _reasons(ps, got2.evicted_keys) == {
        "InCohortReclamation": 20, "InCohortFairSharing": 20}
    assert got2.full_stats.entry_picks > 0
    _host_drs_checks(js, ps)


def test_fair_storm_one_cohort_matches_jax():
    _fair_storm(sessions=True)


def test_fair_storm_sessions_off_matches_jax():
    """The off switch: both engines drain without delta sessions."""
    _fair_storm(sessions=False)


def _afs_backlog(sessions):
    js, jafs, jback = afs_baseline_store(jax_types, JaxStore, JaxAfs,
                                         n_cohorts=1)
    ps, pafs, pback = afs_baseline_store(port_types, PortStore, PortAfs,
                                         n_cohorts=1)
    jax_side, port_side = _fair_engines(js, ps, jafs, pafs, fs=False,
                                        sessions=sessions)
    _add(js, ps, jback, pback)
    assert port_side[2].needs_full_kernel(port_side[2].pending_backlog())
    want, got = _check_drain(jax_side, port_side, 60.0)
    assert (got.admitted, got.rounds) == (120, 22)
    # per ClusterQueue the -b queue admits until its penalty passes the
    # -a queue's decayed charge (20 * 0.5 ** (60 / 300) = 17.41): 19 + 1
    sides = collections.Counter(ps.workloads[k].queue_name[-1]
                                for k in got.admitted_keys)
    assert sides == {"b": 114, "a": 6}
    # the AfsManager recorded every admission as the JAX engine's did
    for name in ps.local_queues:
        assert pafs.weighted_usage(name, 60.0) == jafs.weighted_usage(
            name, 60.0), name


def test_afs_backlog_one_cohort_matches_jax():
    _afs_backlog(sessions=True)


def test_afs_backlog_sessions_off_matches_jax():
    """The off switch on the AFS drain."""
    _afs_backlog(sessions=False)


class _AfsEnv:
    """tests/test_afs.py's Env for either package (one CQ, two
    LocalQueues, half-life 300 s), drained by the engine."""

    def __init__(self, types, store_cls, afs_cls, queues_cls, nominal):
        self.store = store_cls()
        self.store.upsert_resource_flavor(types.ResourceFlavor(
            name="default"))
        self.store.upsert_cluster_queue(types.ClusterQueue(
            name="cq", admission_scope=types.AdmissionScope(),
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="default", resources=[
                    types.ResourceQuota(name="cpu", nominal=nominal)])])]))
        for lq in ("lq-a", "lq-b"):
            self.store.upsert_local_queue(types.LocalQueue(
                name=lq, cluster_queue="cq"))
        self.afs = afs_cls()
        self.queues = queues_cls(self.store, afs=self.afs)
        self.types = types
        self.t = 0.0

    def submit(self, name, lq, cpu=1000):
        self.t += 1.0
        self.store.add_workload(self.types.Workload(
            name=name, queue_name=lq, creation_time=self.t,
            uid=int(self.t), podsets=[self.types.PodSet(
                count=1, requests={"cpu": cpu})]))


def _afs_envs(nominal=2000):
    return (_AfsEnv(jax_types, JaxStore, JaxAfs, JaxQueues, nominal),
            _AfsEnv(port_types, PortStore, PortAfs, PortQueues, nominal))


def _afs_drain(envs, now):
    jenv, penv = envs
    jengine = JaxEngine(jenv.store, jenv.queues, mesh_mode="off")
    pengine = PortEngine(penv.store, penv.queues, device="cpu")
    assert jengine.use_sessions and pengine.use_sessions
    assert pengine.needs_full_kernel(pengine.pending_backlog())
    # one workload axis for every case here: the cases share one JAX
    # compile
    jengine._pad_hwm = pengine._pad_hwm = 8
    return _check_drain((jenv.store, jenv.queues, jengine),
                        (penv.store, penv.queues, pengine), now)


def test_afs_lighter_local_queue_first_matches_jax():
    envs = _afs_envs()
    for env in envs:
        env.afs.record_admission("default/lq-a", {"cpu": 5000}, now=0.0)
        for name, lq in [("a1", "lq-a"), ("a2", "lq-a"),
                         ("b1", "lq-b"), ("b2", "lq-b")]:
            env.submit(name, lq)
    # the JAX host pop order: the lighter LocalQueue's oldest entry
    # first; the port's drain admits in that order
    jhead = envs[0].queues.queues["cq"].pop_head()
    envs[0].queues.queues["cq"].push(jhead)
    assert jhead.key == "default/b1"
    _, got = _afs_drain(envs, 10.0)
    assert got.admitted_keys == ["default/b1", "default/b2"]


def test_afs_entry_penalty_alternates_matches_jax():
    envs = _afs_envs()
    for env in envs:
        for i in range(3):
            env.submit(f"a{i}", "lq-a")
        for i in range(3):
            env.submit(f"b{i}", "lq-b")
    _, got = _afs_drain(envs, 10.0)
    lqs = {envs[1].store.workloads[k].queue_name for k in got.admitted_keys}
    assert len(got.admitted_keys) == 2 and lqs == {"lq-a", "lq-b"}


def test_fair_tas_store_with_preemption_matches_jax():
    kw = dict(n_racks=2, n_hosts=4, n_cohorts=1, n_cqs=3, n_workloads=60,
              preempt=True)
    js = tas_drain_store(jax_types, JaxStore, **kw)
    ps = tas_drain_store(port_types, PortStore, **kw)
    jax_side, port_side = _fair_engines(js, ps)
    want, got = _check_drain(jax_side, port_side, 0.0)
    assert got.admitted > 0 and "placement" in got.phases
    assert plan_rows(ps, got.admitted_keys) == plan_rows(
        js, want.admitted_keys)
