"""The port's lean drain (kueue_oss_tpu_torch/solver/kernels.py) on the
CPU against the JAX package's ``solve_backlog``: problems exported by
the JAX engine from randomized stores (cohort hierarchies, lending and
borrowing limits, two flavors, StrictFIFO, TryNextFlavor; the shapes of
tests/test_solver_parity.py) are carried across with
``convert.problem_from_arrays`` and all six outputs must be bitwise
equal. The port's own export of the same store must equal the JAX
export field by field."""

import random

import numpy as np
import pytest
import torch

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver import kernels as jax_kernels
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import (
    export_problem as jax_export,
    pad_workloads as jax_pad,
    pow2,
)
from kueue_oss_tpu_torch import convert
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.solver import kernels as port_kernels
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.tensors import (
    ARRAY_FIELDS,
    export_problem as port_export,
)

OUTPUTS = ("admitted", "opt", "admit_round", "parked", "rounds", "usage")


def random_store(t, store_cls, seed):
    """A randomized fit-only store (one resource group per CQ) built
    with the API types module ``t``."""
    rng = random.Random(seed)
    store = store_cls()
    n_cohorts = rng.randint(1, 3)
    cohorts = [t.Cohort(name=f"co{i}") for i in range(n_cohorts)]
    if n_cohorts >= 2 and rng.random() < 0.5:
        cohorts[1].parent = cohorts[0].name
    flavor_names = ["f0", "f1"][: rng.randint(1, 2)]
    for f in flavor_names:
        store.upsert_resource_flavor(t.ResourceFlavor(name=f))
    for c in cohorts:
        store.upsert_cohort(c)
    n_cqs = rng.randint(2, 6)
    for i in range(n_cqs):
        bl = rng.choice([None, None, 0, 500, 1000])
        ll = rng.choice([None, None, 0, 500, 1000])
        strategy = (t.QueueingStrategy.STRICT_FIFO if rng.random() < 0.2
                    else t.QueueingStrategy.BEST_EFFORT_FIFO)
        fung = t.FlavorFungibility(
            when_can_borrow=(t.FlavorFungibilityPolicy.TRY_NEXT_FLAVOR
                             if rng.random() < 0.3
                             else t.FlavorFungibilityPolicy.BORROW))
        cohort = (rng.choice(cohorts).name if rng.random() < 0.8 else None)
        store.upsert_cluster_queue(t.ClusterQueue(
            name=f"cq{i}", cohort=cohort,
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name=f, resources=[t.ResourceQuota(
                    name="cpu", nominal=rng.choice([0, 1000, 2000, 4000]),
                    borrowing_limit=bl, lending_limit=ll)])
                    for f in flavor_names])],
            queueing_strategy=strategy, flavor_fungibility=fung))
        store.upsert_local_queue(t.LocalQueue(name=f"lq-cq{i}",
                                              cluster_queue=f"cq{i}"))
    for w in range(rng.randint(5, 40)):
        store.add_workload(t.Workload(
            name=f"w{w}", queue_name=f"lq-cq{rng.randrange(n_cqs)}",
            priority=rng.randint(0, 3), creation_time=float(w % 7),
            uid=1000 + w,
            podsets=[t.PodSet(count=rng.randint(1, 3), requests={
                "cpu": rng.choice([250, 500, 1000, 1500, 3000, 5000])})]))
    return store


def _jax_problem(seed):
    store = random_store(jax_types, JaxStore, seed)
    engine = JaxEngine(store, JaxQueues(store), mesh_mode="off")
    pending = engine.pending_backlog()
    problem = jax_export(store, pending)
    return jax_pad(problem, pow2(problem.n_workloads)), store


@pytest.mark.parametrize("seed", range(8))
def test_solve_backlog_bitwise_equal(seed):
    problem, _ = _jax_problem(seed)
    want = jax_kernels.solve_backlog(jax_kernels.to_device(problem))
    port_problem = convert.problem_from_arrays(problem)
    got = port_kernels.solve_backlog(
        port_kernels.to_device(port_problem, "cpu"))
    for g, w, name in zip(got, want, OUTPUTS):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert np.asarray(want[0]).any(), "vacuous: nothing admitted"


@pytest.mark.parametrize("seed", range(8))
def test_export_matches_jax_field_by_field(seed):
    jstore = random_store(jax_types, JaxStore, seed)
    pstore = random_store(port_types, PortStore, seed)
    jpending = JaxEngine(jstore, JaxQueues(jstore),
                         mesh_mode="off").pending_backlog()
    ppending = PortEngine(pstore, PortQueues(pstore),
                          device="cpu").pending_backlog()
    want = jax_export(jstore, jpending)
    got = port_export(pstore, ppending)
    for name in ARRAY_FIELDS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("fr_list", "node_names", "cq_names", "wl_keys",
                 "cq_option_flavors", "scale"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("seed", range(8, 12))
def test_engine_drain_matches_jax(seed):
    jstore = random_store(jax_types, JaxStore, seed)
    pstore = random_store(port_types, PortStore, seed)
    jq, pq = JaxQueues(jstore), PortQueues(pstore)
    want = JaxEngine(jstore, jq, mesh_mode="off").drain(now=5.0)
    got = PortEngine(pstore, pq, device="cpu").drain(now=5.0)
    assert got.admitted_keys == want.admitted_keys
    assert got.rounds == want.rounds
    for key in want.admitted_keys:
        ja = jstore.workloads[key].status.admission
        pa = pstore.workloads[key].status.admission
        assert pa.cluster_queue == ja.cluster_queue
        assert ([p.flavors for p in pa.podset_assignments]
                == [p.flavors for p in ja.podset_assignments])
    for name in jq.queues:
        assert (sorted(pq.queues[name].inadmissible)
                == sorted(jq.queues[name].inadmissible)), name


def test_problem_from_arrays_checks_dtypes():
    problem, _ = _jax_problem(0)
    arrays = {name: np.asarray(getattr(problem, name))
              for name in ARRAY_FIELDS}
    assert convert.problem_from_arrays(arrays).n_workloads == (
        problem.n_workloads)
    arrays["wl_rank"] = arrays["wl_rank"].astype(np.int64)
    with pytest.raises(TypeError, match="wl_rank"):
        convert.problem_from_arrays(arrays)


def test_to_device_keeps_dtypes():
    problem, _ = _jax_problem(1)
    t = port_kernels.to_device(convert.problem_from_arrays(problem), "cpu")
    assert t.wl_req.dtype == torch.int32
    assert t.wl_valid.dtype == torch.bool
    assert t.is_cq.sum() == problem.n_cqs
