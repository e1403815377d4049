"""The port's FULL (preemption / multi-resource-group) drain end to end
on the CPU against the JAX engine (``mesh_mode="off"``, delta sessions
on in both engines, their default; the storm also with both off),
tolerance 0.

Identical stores come from one builder per case, parameterised by the
types module: the Kueue baseline as a two-wave preemption storm
(2 cohorts x 3 ClusterQueues, class counts x 0.1), the heterogeneous
generator shape with two resource groups (2 x 3 ClusterQueues), the
mixed TAS / plain store of tests/test_solver_tas_mixed.py with a
preemption wave on its plain ClusterQueue, and a small TAS drain store
with preemption on every ClusterQueue. Per drain: the admitted keys in
order, the evicted keys, the flavors per resource group, the rounds,
every workload's conditions (Evicted / Preempted reasons included) and
eviction counters, the topology assignments, and the queues' heap and
parked sets; the FULL export must equal the JAX export field by field.
Workloads with podset topology groups must raise UnsupportedProblem
(fair sharing and admission fair sharing drain: see
tests/test_torch_engine_fair.py)."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import export_problem as jax_export
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.scenarios import (
    baseline_preempt_store,
    heterogeneous_preempt_store,
    plan_rows,
    preempt_plan_rows,
    tas_drain_store,
)
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.tensors import (
    ARRAY_FIELDS,
    FULL_ARRAY_FIELDS,
    UnsupportedProblem,
    export_problem as port_export,
)

RACK = "cloud/rack"
HOST = "kubernetes.io/hostname"


def _conditions(store):
    return {key: ({t: (c.status, c.reason, c.last_transition_time)
                   for t, c in wl.status.conditions.items()},
                  [(e.reason, e.count) for e in wl.status.eviction_stats])
            for key, wl in store.workloads.items()}


def _topologies(store, keys):
    out = []
    for key in keys:
        for psa in store.workloads[key].status.admission.podset_assignments:
            ta = psa.topology_assignment
            out.append(None if ta is None else
                       (ta.levels, [(d.values, d.count) for d in ta.domains]))
    return out


def _check_drain(jax_side, port_side, now):
    (js, jq, je), (ps, pq, pe) = jax_side, port_side
    want = je.drain(now=now)
    got = pe.drain(now=now)
    assert got.admitted_keys == want.admitted_keys
    assert got.evicted_keys == want.evicted_keys
    assert (got.admitted, got.evicted, got.rounds) == (
        want.admitted, want.evicted, want.rounds)
    assert preempt_plan_rows(ps, got) == preempt_plan_rows(js, want)
    assert _topologies(ps, got.admitted_keys) == _topologies(
        js, want.admitted_keys)
    assert _conditions(ps) == _conditions(js)
    for name in jq.queues:
        assert (sorted(pq.queues[name].inadmissible)
                == sorted(jq.queues[name].inadmissible)), name
        assert (sorted(pq.queues[name]._in_heap)
                == sorted(jq.queues[name]._in_heap)), name
    assert got.full_stats is not None and got.full_stats.lanes > 0
    return want, got


def _engines(js, ps, sessions=True):
    """The JAX engine without a mesh (a mesh re-lays workload rows over
    its shards), and both engines with delta sessions on, their default
    (the sessions re-lay a later drain's rows into stable slots the same
    way in both packages), or both with ``use_sessions = False``, the
    off switch."""
    jq, pq = JaxQueues(js), PortQueues(ps)
    jengine = JaxEngine(js, jq, mesh_mode="off")
    pengine = PortEngine(ps, pq, device="cpu")
    assert jengine.use_sessions and pengine.use_sessions
    jengine.use_sessions = pengine.use_sessions = sessions
    return ((js, jq, jengine), (ps, pq, pengine))


def _full_exports(jax_side, port_side):
    """The FULL exports of both engines' current backlogs (parked map as
    the engines build it; the JAX export without its cross-drain
    cache)."""
    out = []
    for (store, queues, engine), inadm in ((jax_side, "inadmissible"),
                                           (port_side, "inadmissible")):
        pending = engine.pending_backlog()
        parked = {name: list(getattr(q, inadm).values())
                  for name, q in queues.queues.items()
                  if getattr(q, inadm)}
        export = jax_export if engine is jax_side[2] else port_export
        out.append(export(store, pending, include_admitted=True,
                          parked=parked))
    return out


def _storm(sessions):
    kw = dict(n_cohorts=2, cqs_per_cohort=3, scale=0.1)
    js, jw1, jw2 = baseline_preempt_store(jax_types, JaxStore, **kw)
    ps, pw1, pw2 = baseline_preempt_store(port_types, PortStore, **kw)
    jax_side, port_side = _engines(js, ps, sessions)
    for wl in jw1:
        js.add_workload(wl)
    for wl in pw1:
        ps.add_workload(wl)
    want1, _ = _check_drain(jax_side, port_side, 100.0)
    assert (want1.admitted, want1.evicted) == (120, 0)
    for wl in jw2:
        js.add_workload(wl)
    for wl in pw2:
        ps.add_workload(wl)
    want_p, got_p = _full_exports(jax_side, port_side)
    for name in ARRAY_FIELDS + FULL_ARRAY_FIELDS:
        w = np.asarray(getattr(want_p, name))
        g = getattr(got_p, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("fr_list", "node_names", "cq_names", "wl_keys",
                 "cq_option_flavors", "cq_resource_group", "scale",
                 "n_classes", "n_resources", "ts_evict_base",
                 "admit_rank_base"):
        assert getattr(got_p, name) == getattr(want_p, name), name
    want2, got2 = _check_drain(jax_side, port_side, 200.0)
    # at this size every ClusterQueue's large preempts the smalls of
    # its own queue (each queue holds exactly its nominal quota)
    assert (want2.admitted, want2.evicted) == (6, 120)
    reasons = {ps.workloads[k].status.conditions["Preempted"].reason
               for k in got2.evicted_keys}
    assert reasons == {"InClusterQueue"}


def test_baseline_two_wave_preemption_storm_matches_jax():
    _storm(sessions=True)


def test_baseline_storm_sessions_off_matches_jax():
    """The off switch (``KUEUE_SOLVER_SESSIONS=0``): both engines drain
    the storm without delta sessions."""
    _storm(sessions=False)


def test_two_resource_groups_match_jax():
    kw = dict(n_cohorts=2, cqs_per_cohort=3, scale=0.4)
    js, jw1, jw2 = heterogeneous_preempt_store(jax_types, JaxStore, **kw)
    ps, pw1, pw2 = heterogeneous_preempt_store(port_types, PortStore, **kw)
    jax_side, port_side = _engines(js, ps)
    for jw, pw, now in ((jw1, pw1, 100.0), (jw2, pw2, 200.0)):
        for wl in jw:
            js.add_workload(wl)
        for wl in pw:
            ps.add_workload(wl)
        want, got = _check_drain(jax_side, port_side, now)
        assert want.admitted > 0
    assert want.evicted > 0
    groups = {tuple(sorted({r for psa in
                            ps.workloads[k].status.admission
                            .podset_assignments for r in psa.flavors}))
              for k in got.admitted_keys}
    assert ("cpu", "gpu", "memory") in groups


def _mixed_store(types, store_cls):
    """tests/test_solver_tas_mixed.py's store for either package."""
    store = store_cls()
    store.upsert_topology(types.Topology(name="default",
                                         levels=[RACK, HOST]))
    store.upsert_resource_flavor(types.ResourceFlavor(
        name="tas-flavor", topology_name="default"))
    store.upsert_resource_flavor(types.ResourceFlavor(name="plain"))
    for r in range(2):
        for h in range(2):
            store.upsert_node(types.Node(
                name=f"n-{r}-{h}", labels={RACK: f"r{r}"},
                allocatable={"cpu": 4000}))
    store.upsert_cohort(types.Cohort(name="co"))
    store.upsert_cluster_queue(types.ClusterQueue(
        name="cq-tas",
        resource_groups=[types.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[types.FlavorQuotas(name="tas-flavor", resources=[
                types.ResourceQuota(name="cpu", nominal=16000)])])]))
    store.upsert_local_queue(types.LocalQueue(name="lq-tas",
                                              cluster_queue="cq-tas"))
    store.upsert_cluster_queue(types.ClusterQueue(
        name="cq-plain", cohort="co",
        preemption=types.PreemptionPolicy(
            within_cluster_queue=(
                types.PreemptionPolicyValue.LOWER_PRIORITY)),
        resource_groups=[types.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[types.FlavorQuotas(name="plain", resources=[
                types.ResourceQuota(name="cpu", nominal=4000)])])]))
    store.upsert_local_queue(types.LocalQueue(name="lq-plain",
                                              cluster_queue="cq-plain"))
    return store


def _mixed_waves(types):
    tr = types.PodSetTopologyRequest
    wave1 = [types.Workload(
        name="tas-wl", queue_name="lq-tas", uid=1, creation_time=0.0,
        podsets=[types.PodSet(name="main", count=4,
                              requests={"cpu": 1000},
                              topology_request=tr(required=RACK))])]
    wave1 += [types.Workload(
        name=f"plain-{i}", queue_name="lq-plain", uid=2 + i,
        creation_time=1.0 + i, priority=0,
        podsets=[types.PodSet(name="main", count=1,
                              requests={"cpu": 1000})]) for i in range(4)]
    wave2 = [types.Workload(
        name="tas-b", queue_name="lq-tas", uid=10, creation_time=5.0,
        podsets=[types.PodSet(name="main", count=2, requests={"cpu": 2000},
                              topology_request=tr(preferred=HOST))]),
             types.Workload(
        name="tas-c", queue_name="lq-tas", uid=11, creation_time=6.0,
        podsets=[types.PodSet(name="main", count=2, requests={"cpu": 1000},
                              topology_request=tr(unconstrained=True))]),
             types.Workload(
        name="urgent", queue_name="lq-plain", uid=12, creation_time=7.0,
        priority=10,
        podsets=[types.PodSet(name="main", count=1,
                              requests={"cpu": 2000})])]
    return wave1, wave2


def test_mixed_tas_and_plain_store_matches_jax():
    js = _mixed_store(jax_types, JaxStore)
    ps = _mixed_store(port_types, PortStore)
    jax_side, port_side = _engines(js, ps)
    for (jw, pw), now in zip(zip(_mixed_waves(jax_types),
                                 _mixed_waves(port_types)), (2.0, 3.0)):
        for wl in jw:
            js.add_workload(wl)
        for wl in pw:
            ps.add_workload(wl)
        want, got = _check_drain(jax_side, port_side, now)
    assert "default/tas-b" in got.admitted_keys
    assert got.evicted_keys == ["default/plain-0", "default/plain-1"]
    ta = ps.workloads["default/tas-wl"].status.admission \
        .podset_assignments[0].topology_assignment
    assert sum(d.count for d in ta.domains) == 4


def test_tas_store_with_preemption_matches_jax():
    kw = dict(n_racks=4, n_hosts=8, n_cohorts=2, n_cqs=3, n_workloads=300,
              preempt=True)
    js = tas_drain_store(jax_types, JaxStore, **kw)
    ps = tas_drain_store(port_types, PortStore, **kw)
    jax_side, port_side = _engines(js, ps)
    want, got = _check_drain(jax_side, port_side, 0.0)
    assert got.admitted > 0
    assert plan_rows(ps, got.admitted_keys) == plan_rows(
        js, want.admitted_keys)
    assert "placement" in got.phases


def test_fair_sharing_afs_and_podset_groups_refuse():
    """Only podset topology groups still refuse: fair sharing and
    admission fair sharing drain (tests/test_torch_engine_fair.py)."""
    kw = dict(n_cohorts=1, cqs_per_cohort=2, scale=0.02)
    ps, w1, _ = baseline_preempt_store(port_types, PortStore, **kw)
    for wl in w1:
        ps.add_workload(wl)
    pq = PortQueues(ps)
    engine = PortEngine(ps, pq, device="cpu")
    # a podset-group workload never joins a drain backlog (its TAS CQ
    # stays on the host path); the export refuses it outright
    wl = ps.workloads[w1[0].key]
    wl.podsets[0].topology_request = port_types.PodSetTopologyRequest(
        required=RACK, podset_group_name="g")
    pending = engine.pending_backlog()
    pending["cq-0-0"] = [WorkloadInfo(wl, cluster_queue="cq-0-0")]
    with pytest.raises(UnsupportedProblem, match="podset topology groups"):
        port_export(ps, pending, include_admitted=True)
