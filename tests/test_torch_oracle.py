"""The port's verify oracle (``kueue_oss_tpu_torch.native``) against the
JAX package's (``kueue_oss_tpu.native``), tolerance 0, and
``SolverEngine.drain(verify=True)`` against the JAX engine's.

Seeded random cohort forests of two and three levels (cohort quotas,
lending and borrowing limits, two flavors x two resources, usage
charged before the check) take a random admission sequence that also
holds an admission altered to overcommit its ClusterQueue, one naming
an unknown flavor-resource and one naming a deleted ClusterQueue. Both
packages' oracles, on the native path and with ``force_python=True``,
must give the same verdicts and the same final ``usage`` arrays.

The engine tests drain a lean store and the FULL baseline storm with
``verify=True`` on both packages, and monkeypatch both oracles to
reject every seventh candidate: the rejected entries are not committed,
stay queued and are counted in ``DrainResult.plan_fallbacks``.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import shutil

import numpy as np
import pytest

from kueue_oss_tpu import native as jax_native
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.quota import QuotaForest as JaxForest
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu_torch import native as port_native
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.quota import QuotaForest as PortForest
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine

FLAVORS = ("f0", "f1")
RESOURCES = ("cpu", "mem")


def _quotas(types, rng, lo, hi):
    out = []
    for f in FLAVORS:
        rqs = []
        for r in RESOURCES:
            rqs.append(types.ResourceQuota(
                name=r, nominal=int(rng.integers(lo, hi)),
                borrowing_limit=(None if rng.random() < 0.4
                                 else int(rng.integers(0, hi))),
                lending_limit=(None if rng.random() < 0.5
                               else int(rng.integers(0, hi)))))
        out.append(types.FlavorQuotas(name=f, resources=rqs))
    return [types.ResourceGroup(covered_resources=list(RESOURCES),
                                flavors=out)]


def _forest_spec(types, seed: int, depth: int):
    """(cluster queues, cohorts) of a random forest of ``depth`` levels
    of cohorts; the same seed gives the same objects in either
    package."""
    rng = np.random.default_rng(seed)
    cohorts, leaves = [], []
    for r in range(int(rng.integers(1, 3))):
        root = f"root{r}"
        cohorts.append(types.Cohort(
            name=root, resource_groups=(_quotas(types, rng, 0, 6)
                                        if rng.random() < 0.5 else [])))
        leaves.append(root)
        if depth == 3:
            for c in range(int(rng.integers(1, 3))):
                name = f"{root}-c{c}"
                cohorts.append(types.Cohort(
                    name=name, parent=root,
                    resource_groups=(_quotas(types, rng, 0, 6)
                                     if rng.random() < 0.3 else [])))
                leaves.append(name)
    cqs = []
    for i in range(int(rng.integers(3, 8))):
        cqs.append(types.ClusterQueue(
            name=f"cq{i}", cohort=leaves[int(rng.integers(0, len(leaves)))],
            resource_groups=_quotas(types, rng, 0, 12)))
    return cqs, cohorts


def _forest(types, forest_cls, seed, depth):
    cqs, cohorts = _forest_spec(types, seed, depth)
    forest = forest_cls()
    forest.build(cqs, cohorts)
    rng = np.random.default_rng(seed + 1000)
    # usage already charged when the plan is checked
    for name in sorted(forest.cqs):
        for f in FLAVORS:
            for r in RESOURCES:
                if rng.random() < 0.5:
                    forest.cqs[name].add_usage((f, r),
                                               int(rng.integers(0, 8)))
    return forest


def _admissions(seed: int, cq_names: list) -> list:
    rng = np.random.default_rng(seed + 2000)
    out = []
    for _ in range(40):
        usage = {}
        for f in FLAVORS:
            for r in RESOURCES:
                if rng.random() < 0.4:
                    usage[(f, r)] = int(rng.integers(0, 9))
        out.append((cq_names[int(rng.integers(0, len(cq_names)))], usage))
    # an entry altered to overcommit its ClusterQueue
    cq, usage = out[5]
    out[5] = (cq, {**usage, ("f0", "cpu"): 10_000})
    out.insert(11, (cq_names[0], {("ghost", "cpu"): 1}))   # unknown fr
    out.insert(17, ("deleted-cq", {("f1", "mem"): 1}))     # gone CQ
    return out


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_oracles_agree(seed, depth):
    admissions = None
    results = {}
    for pkg, types, forest_cls, native in (
            ("jax", jax_types, JaxForest, jax_native),
            ("port", port_types, PortForest, port_native)):
        for force_python in (False, True):
            forest = _forest(types, forest_cls, seed, depth)
            if admissions is None:
                admissions = _admissions(seed, sorted(forest.cqs))
            before = {n: dict(node.usage) for n, node in forest.cqs.items()}
            oracle = native.BatchOracle(forest.cqs)
            ok = oracle.verify_and_apply(admissions,
                                         force_python=force_python)
            # the oracle charges only its own state
            assert {n: dict(node.usage)
                    for n, node in forest.cqs.items()} == before
            results[(pkg, force_python)] = (ok.tolist(),
                                            oracle.usage.tolist())
    want = results[("jax", False)]
    assert all(r == want for r in results.values())
    ok = want[0]
    assert ok[5] == 0 and ok[11] == 0 and ok[17] == 0
    assert 0 < sum(ok) < len(ok)


def test_native_path_runs_and_is_counted():
    if shutil.which("g++") is None:
        pytest.skip("no g++: every call takes the counted Python walk")
    forest = _forest(port_types, PortForest, 3, 3)
    admissions = _admissions(3, sorted(forest.cqs))
    port_native.reset_counters()
    ok = port_native.BatchOracle(forest.cqs).verify_and_apply(admissions)
    port_native.BatchOracle(forest.cqs).verify_and_apply(
        admissions, force_python=True)
    c = port_native.counters
    assert (c["native_calls"], c["python_calls"]) == (1, 1)
    assert c["entries"] == 2 * len(admissions)
    assert c["rejections"] == 2 * (len(admissions) - int(ok.sum()))
    path = port_native.library_path()
    assert path.is_file() and path.parent == port_native.BUILD_DIR
    assert path.parent.name == "_build"


# -- drain(verify=True) ----------------------------------------------------


def _lean_store(types, store_cls):
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    store.upsert_cohort(types.Cohort(name="co"))
    for i in range(4):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", cohort="co" if i < 3 else None,
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=6,
                                        borrowing_limit=4)])])]))
        store.upsert_local_queue(types.LocalQueue(name=f"lq{i}",
                                                  cluster_queue=f"cq{i}"))
    for i in range(60):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            priority=i % 3, creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1 + i % 2})]))
    return [(store, [])]


def _storm(types, store_cls):
    store, wave1, wave2 = baseline_preempt_store(
        types, store_cls, n_cohorts=2, cqs_per_cohort=3, scale=0.1)
    return [(store, wave1), (store, wave2)]


def _state(store, queues, heap_attr):
    return ({k: (w.is_quota_reserved, w.is_evicted,
                 None if w.status.admission is None else
                 w.status.admission.podset_assignments[0].flavors)
             for k, w in store.workloads.items()},
            {n: (sorted(getattr(q, heap_attr)), sorted(q.inadmissible))
             for n, q in queues.queues.items()})


def _reject_every_seventh(monkeypatch, native):
    real = native.BatchOracle.verify_and_apply

    def verify(self, admissions, force_python=False):
        ok = real(self, admissions, force_python=force_python)
        ok[::7] = 0
        return ok
    monkeypatch.setattr(native.BatchOracle, "verify_and_apply", verify)


@pytest.mark.parametrize("reject", [False, True])
@pytest.mark.parametrize("build", [_lean_store, _storm],
                         ids=["lean", "full"])
def test_drain_verify_matches_jax(build, reject, monkeypatch):
    if reject:
        _reject_every_seventh(monkeypatch, jax_native)
        _reject_every_seventh(monkeypatch, port_native)
    j_steps = build(jax_types, JaxStore)
    p_steps = build(port_types, PortStore)
    jq, pq = JaxQueues(j_steps[0][0]), PortQueues(p_steps[0][0])
    je = JaxEngine(j_steps[0][0], jq, mesh_mode="off")
    pe = PortEngine(p_steps[0][0], pq, device="cpu")
    # the relaxed arm routes by wall clock: pinned off on both sides
    je.relax_enabled = pe.relax_enabled = False
    for t, ((js, jwave), (ps, pwave)) in enumerate(zip(j_steps, p_steps)):
        for wl in jwave:
            js.add_workload(wl)
        for wl in pwave:
            ps.add_workload(wl)
        now = 100.0 * (t + 1)
        want = je.drain(now=now, verify=True)
        got = pe.drain(now=now, verify=True)
        assert want.admitted > 0, "vacuous: nothing admitted"
        assert got.admitted_keys == want.admitted_keys
        assert got.evicted_keys == want.evicted_keys
        assert _state(ps, pq, "_in_heap") == _state(js, jq, "_in_heap")
        assert got.verified == got.admitted + got.plan_fallbacks
        if not reject:
            assert got.plan_fallbacks == 0
            continue
        rejected = got.verified - got.admitted
        assert got.plan_fallbacks == rejected > 0
        # a rejected entry is not committed and stays in its heap
        queued = {k for q in pq.queues.values() for k in q._in_heap}
        committed = set(got.admitted_keys)
        candidates = [k for k, w in ps.workloads.items()
                      if k in queued and not w.is_quota_reserved]
        assert len(candidates) >= rejected
        assert not committed & queued
