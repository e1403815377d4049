"""The port's TAS solver drain end to end on the CPU against the JAX
engine: identical stores built by one builder
(kueue_oss_tpu_torch.scenarios.tas_drain_store, parameterised by the
types module) in a reduced tas_drain shape — 2 cohorts x 3 ClusterQueues,
4 racks x 8 hosts, 600 workloads with required / preferred /
unconstrained rack requests. Both drains must admit the same keys in
the same order, in the same rounds, with the same flavors and topology
assignments, and park the same workloads; the port's export must equal
the JAX export field by field."""

import numpy as np
import pytest
import torch

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import export_problem as jax_export
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.afs import AfsManager
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scenarios import plan_digest, plan_rows
from kueue_oss_tpu_torch.scenarios import tas_drain_store
from kueue_oss_tpu_torch.solver import cuda_tas
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.tensors import (
    ARRAY_FIELDS,
    export_problem as port_export,
)

REDUCED = dict(n_racks=4, n_hosts=8, n_cohorts=2, n_cqs=3,
               n_workloads=600)


def _both(seed):
    js = tas_drain_store(jax_types, JaxStore, seed=seed, **REDUCED)
    ps = tas_drain_store(port_types, PortStore, seed=seed, **REDUCED)
    return (js, JaxQueues(js)), (ps, PortQueues(ps))


@pytest.mark.parametrize("seed", [640, 7])
def test_tas_drain_matches_jax(seed):
    (js, jq), (ps, pq) = _both(seed)
    want = JaxEngine(js, jq, mesh_mode="off").drain(now=0.0)
    got = PortEngine(ps, pq, device="cpu").drain(now=0.0)
    assert want.admitted > 0, "vacuous: nothing admitted"
    assert got.admitted_keys == want.admitted_keys
    assert (got.admitted, got.rounds, got.evicted) == (
        want.admitted, want.rounds, want.evicted)
    assert plan_rows(ps, got.admitted_keys) == plan_rows(
        js, want.admitted_keys)
    assert plan_digest(ps, got.admitted_keys) == plan_digest(
        js, want.admitted_keys)
    modes = set()
    for key in want.admitted_keys:
        tr = js.workloads[key].podsets[0].topology_request
        modes.add("required" if tr.required else
                  "preferred" if tr.preferred else "unconstrained")
        assert (ps.workloads[key].status.conditions.keys()
                == js.workloads[key].status.conditions.keys())
    assert modes == {"required", "preferred", "unconstrained"}
    for name in jq.queues:
        assert (sorted(pq.queues[name].inadmissible)
                == sorted(jq.queues[name].inadmissible)), name
        assert (sorted(pq.queues[name].in_heap)
                == sorted(jq.queues[name]._in_heap)), name


def test_second_drain_after_deletions_matches_jax():
    """Deleting admitted workloads frees quota and topology capacity and
    flushes the cohort's parked workloads back into their heaps; the
    next drain must again equal the JAX engine's."""
    (js, jq), (ps, pq) = _both(640)
    jengine = JaxEngine(js, jq, mesh_mode="off")
    pengine = PortEngine(ps, pq, device="cpu")
    first = jengine.drain(now=0.0)
    assert pengine.drain(now=0.0).admitted_keys == first.admitted_keys
    for key in first.admitted_keys[::4]:
        js.delete_workload(key)
        ps.delete_workload(key)
    want = jengine.drain(now=1.0)
    got = pengine.drain(now=1.0)
    assert want.admitted > 0, "vacuous: nothing admitted again"
    assert got.admitted_keys == want.admitted_keys
    assert got.rounds == want.rounds
    assert plan_rows(ps, got.admitted_keys) == plan_rows(
        js, want.admitted_keys)


def test_tas_export_matches_jax_field_by_field():
    (js, jq), (ps, pq) = _both(640)
    jpending = JaxEngine(js, jq, mesh_mode="off").pending_backlog()
    ppending = PortEngine(ps, pq, device="cpu").pending_backlog()
    assert list(ppending) == list(jpending)
    want = jax_export(js, jpending)
    got = port_export(ps, ppending)
    for name in ARRAY_FIELDS:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("fr_list", "node_names", "cq_names", "wl_keys",
                 "cq_option_flavors", "scale"):
        assert getattr(got, name) == getattr(want, name), name


def test_cpu_drain_places_through_the_plain_leaf_pass():
    _, (ps, pq) = _both(640)
    before = cuda_tas.leaf_states.launches
    got = PortEngine(ps, pq, device="cpu").drain(now=0.0)
    assert got.admitted > 0
    assert "placement" in got.phases
    assert cuda_tas.leaf_states.launches == before


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py drives it")
    _, (ps, pq) = _both(640)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEngine(ps, pq).drain()


def test_verify_and_full_shapes_refuse():
    """verify=True refuses (podset groups refuse in
    tests/test_torch_engine_full.py). An admission scope routes the FULL
    path only when the queues have an AfsManager, as in the JAX engine
    (the AFS drain: tests/test_torch_engine_fair.py); a
    preemption-enabled CQ drains through the FULL path."""
    _, (ps, pq) = _both(640)
    engine = PortEngine(ps, pq, device="cpu")
    with pytest.raises(NotImplementedError):
        engine.drain(verify=True)
    cq = ps.cluster_queues["cq-0-0"]
    cq.admission_scope = port_types.AdmissionScope()
    assert not engine.needs_full_kernel(engine.pending_backlog())
    afs_engine = PortEngine(ps, PortQueues(ps, afs=AfsManager()),
                            device="cpu")
    assert afs_engine.needs_full_kernel(afs_engine.pending_backlog())
    cq.admission_scope = None
    cq.preemption.within_cluster_queue = (
        port_types.PreemptionPolicyValue.LOWER_PRIORITY)
    assert engine.drain().full_stats is not None
