"""Request shaping from a loaded Configuration, port against JAX.

``config.load`` gives the ``resources`` section (exclude prefixes,
transformations, QuotaCheckStrategy=IgnoreUndeclared) and
``core.workload_info.set_limit_ranges`` the namespaces' LimitRange
default requests; every path that computes a workload's requests reads
them. With them set in both packages, the port's ``export_problem``
arrays must equal the JAX package's (the JAX export is numpy: no
compile), the ``ExportCache`` must miss after ``set_resources_config``
(its stamp carries ``requests_config_generation()``) so a config
change never serves a stale export, the host scheduler's flavor
assigner must admit the same workloads with the same usage, and one
small lean drain must give the JAX plan (one JAX compile). The
tolerance is exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest

from kueue_oss_tpu import config as jax_config
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core import workload_info as jax_wli
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu.sim.engine import pending_backlog as jax_pending
from kueue_oss_tpu.solver import tensors as jax_tensors
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu_torch import config as port_config
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core import workload_info as port_wli
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PortScheduler
from kueue_oss_tpu_torch.sim.engine import pending_backlog as port_pending
from kueue_oss_tpu_torch.solver import tensors as port_tensors
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine

JAX = (jax_config, jax_types, jax_wli, JaxStore, JaxQueues, jax_pending,
       jax_tensors)
PORT = (port_config, port_types, port_wli, PortStore, PortQueues,
        port_pending, port_tensors)

#: the Configuration's resources section: a MIG slice replaced by GPU
#: memory units, cpu also charged as credits, ephemeral storage and
#: hugepages excluded, undeclared resources (memory here) ignored
DOC = {"resources": {
    "excludeResourcePrefixes": ["ephemeral-", "hugepages-"],
    "transformations": [
        {"input": "nvidia.com/mig-1g", "strategy": "Replace",
         "outputs": {"example.com/gpu-mem": 5.0}},
        {"input": "cpu", "strategy": "Retain",
         "outputs": {"example.com/credits": 0.5}}],
    "quotaCheckStrategy": "IgnoreUndeclared"}}
#: LimitRange default requests per namespace (memory is undeclared:
#: ignored by the quota check, still a request)
LIMIT_RANGES = {"team-a": {"cpu": 250, "memory": 512},
                "team-b": {"nvidia.com/mig-1g": 1}}
RESOURCES = ("cpu", "memory", "nvidia.com/mig-1g", "ephemeral-storage",
             "hugepages-2Mi")


@pytest.fixture(autouse=True)
def _clear_request_config():
    for wli in (jax_wli, port_wli):
        wli.set_resources_config(None)
        wli.set_limit_ranges({})
    yield
    for wli in (jax_wli, port_wli):
        wli.set_resources_config(None)
        wli.set_limit_ranges({})


def _install(pkg, doc=DOC, limit_ranges=LIMIT_RANGES):
    config, _, wli = pkg[:3]
    cfg = config.load(doc)
    assert config.validate(cfg) == []
    wli.set_resources_config(cfg.resources)
    wli.set_limit_ranges(limit_ranges)
    return cfg


def _store(pkg, seed: int = 7, n: int = 48):
    """Two cohorts of two ClusterQueues covering cpu, credits and GPU
    memory, LocalQueues in three namespaces, and ``n`` seeded workloads
    with numbered uids."""
    _, types, _, store_cls = pkg[:4]
    rng = np.random.default_rng(seed)
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    store.upsert_resource_flavor(types.ResourceFlavor(name="g"))
    for c in range(2):
        store.upsert_cohort(types.Cohort(name=f"co{c}"))
        for q in range(2):
            name = f"cq{c}{q}"
            store.upsert_cluster_queue(types.ClusterQueue(
                name=name, cohort=f"co{c}",
                resource_groups=[
                    types.ResourceGroup(
                        covered_resources=["cpu", "example.com/credits"],
                        flavors=[types.FlavorQuotas(name="f", resources=[
                            types.ResourceQuota(name="cpu", nominal=4000),
                            types.ResourceQuota(name="example.com/credits",
                                                nominal=1500)])]),
                    types.ResourceGroup(
                        covered_resources=["example.com/gpu-mem"],
                        flavors=[types.FlavorQuotas(name="g", resources=[
                            types.ResourceQuota(name="example.com/gpu-mem",
                                                nominal=40)])])]))
            for ns in ("default", "team-a", "team-b"):
                store.upsert_local_queue(types.LocalQueue(
                    name=f"lq{c}{q}", namespace=ns,
                    cluster_queue=name))
    for i in range(n):
        ns = ("default", "team-a", "team-b")[int(rng.integers(0, 3))]
        names = rng.choice(RESOURCES, size=int(rng.integers(0, 4)),
                           replace=False)
        requests = {str(r): int(rng.integers(1, 4)) * (
            100 if r == "cpu" else 1) for r in names}
        store.add_workload(types.Workload(
            name=f"w{i}", namespace=ns,
            queue_name=f"lq{i % 2}{(i // 2) % 2}", uid=i + 1, creation_time=float(i),
            priority=int(rng.integers(0, 3)),
            podsets=[types.PodSet(name="main",
                                  count=int(rng.integers(1, 4)),
                                  requests=requests)]))
    return store


def _export(pkg, store, cache=None):
    _, _, _, _, queues_cls, pending, tensors = pkg
    backlog = pending(store, queues_cls(store))
    if cache is None:
        cache = tensors.ExportCache(store, subscribe=False)
    return tensors.export_problem(store, backlog, cache=cache)


def _assert_problems_equal(got, want):
    """Every field of the two exports: arrays bit for bit, the rest
    equal."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
        else:
            assert a == b, name


def test_effective_requests_match_jax():
    for pkg in (JAX, PORT):
        _install(pkg)
    jstore, pstore = _store(JAX), _store(PORT)
    for key, wl in jstore.workloads.items():
        pwl = pstore.workloads[key]
        for ps, pps in zip(wl.podsets, pwl.podsets):
            want = jax_wli.effective_per_pod_requests(ps, wl.namespace)
            got = port_wli.effective_per_pod_requests(pps, pwl.namespace)
            assert got == want and list(got) == list(want), key
    assert port_wli.ignore_undeclared_resources()
    assert jax_wli.ignore_undeclared_resources()


@pytest.mark.parametrize("configured", ["resources_and_limits",
                                        "limits_only", "none"])
def test_export_matches_jax(configured):
    for pkg in (JAX, PORT):
        if configured == "resources_and_limits":
            _install(pkg)
        elif configured == "limits_only":
            _install(pkg, doc={})
    jp = _export(JAX, _store(JAX))
    pp = _export(PORT, _store(PORT))
    _assert_problems_equal(pp, jp)
    valid = np.asarray(pp.wl_valid)
    if configured == "resources_and_limits":
        # every workload has an option: memory is ignored, the
        # excluded and transformed resources left the request
        assert valid[:len(pp.wl_keys)].any(axis=1).all()
    else:
        # undeclared memory and the MIG slice park at export
        assert not valid[:len(pp.wl_keys)].any(axis=1).all()


def test_export_cache_misses_after_set_resources_config():
    jstore, pstore = _store(JAX), _store(PORT)
    pcache = port_tensors.ExportCache(pstore, subscribe=False)
    first = _export(PORT, pstore, cache=pcache)
    stamp = pcache._stamp
    gen = port_wli.requests_config_generation()
    for pkg in (JAX, PORT):
        _install(pkg)
    assert port_wli.requests_config_generation() == gen + 2
    second = _export(PORT, pstore, cache=pcache)
    assert pcache._stamp != stamp, "the stamp must carry the generation"
    # the cached export is the fresh one under the new config, and JAX's
    _assert_problems_equal(second, _export(PORT, pstore))
    _assert_problems_equal(second, _export(JAX, jstore))
    assert not np.array_equal(np.asarray(first.wl_valid),
                              np.asarray(second.wl_valid))
    # and back: clearing the config misses again
    for wli in (jax_wli, port_wli):
        wli.set_resources_config(None)
        wli.set_limit_ranges({})
    _assert_problems_equal(_export(PORT, pstore, cache=pcache), first)


def test_admitted_infos_follow_the_config():
    """The store's cached WorkloadInfo of admitted workloads is dropped
    when the request-shaping config changes (JAX store.py:283-310), and
    kept while it does not."""
    store = _store(PORT)
    PortScheduler(store, PortQueues(store), device="cpu").run_until_quiet(
        now=10.0)
    before = {i.key: i for i in store.admitted_infos()}
    assert before
    assert all(before[i.key] is i for i in store.admitted_infos())
    _install(PORT)
    after = {i.key: i for i in store.admitted_infos()}
    assert after.keys() == before.keys()
    assert not any(after[k] is before[k] for k in before)
    assert all(after[i.key] is i for i in store.admitted_infos())


def _admissions(store):
    return sorted(
        (k, w.status.admission.cluster_queue,
         [(psa.name, sorted(psa.flavors.items()),
           sorted(psa.resource_usage.items()), psa.count)
          for psa in w.status.admission.podset_assignments])
        for k, w in store.workloads.items() if w.is_quota_reserved)


def test_host_scheduler_ignores_undeclared_like_jax():
    """The flavor assigner's IgnoreUndeclared site: host cycles admit
    the same workloads with the same flavors and usage."""
    for pkg in (JAX, PORT):
        _install(pkg)
    jstore, pstore = _store(JAX), _store(PORT)
    JaxScheduler(jstore, JaxQueues(jstore)).run_until_quiet(now=10.0)
    PortScheduler(pstore, PortQueues(pstore), device="cpu").run_until_quiet(
        now=10.0)
    want = _admissions(jstore)
    assert want and _admissions(pstore) == want
    # memory (undeclared) is carried as usage but has no flavor
    assert any("memory" in dict(psa[2]) and "memory" not in dict(psa[1])
               for _, _, pss in want for psa in pss)


def test_lean_drain_plan_matches_jax():
    """One small drain through each engine (one JAX compile)."""
    for pkg in (JAX, PORT):
        _install(pkg)
    jstore, pstore = _store(JAX), _store(PORT)
    jeng = JaxEngine(jstore, JaxQueues(jstore), mesh_mode="off")
    peng = PortEngine(pstore, PortQueues(pstore), device="cpu")
    peng.relax_enabled = False
    jeng.relax_enabled = False
    want = jeng.drain(now=10.0)
    got = peng.drain(now=10.0)
    assert got.admitted == want.admitted > 0
    assert got.rounds == want.rounds
    assert got.admitted_keys == want.admitted_keys
    assert _admissions(pstore) == _admissions(jstore)
