"""The port's scheduler with the host TAS placement against the JAX one,
tolerance 0.

The scheduler-integration scenarios of ``tests/test_tas.py`` (a
topology assignment written at admission, the implied request of a
TAS-only ClusterQueue, usage visible the next cycle, a topology too
small, no same-cycle oversubscription of a host by single or
multi-podset workloads, fragmentation resolved by preemption, eviction
clearing the unhealthy nodes) and a few more of the ported paths (the
victims-removed placement of a preempting leader group, partial
admission on a topology, the delayed topology of an admission-check
ClusterQueue and its second pass) run on identical stores of both
packages through the same calls. After every step the committed-store
digest (``tests/torch_scheduler_pins.py``), the cycle statistics, each
queue's heap and parked sets, the second-pass queue and every podset's
delayed-topology state must be equal. Each case runs with the host
roll-up and with TASDeviceFillCounts on (the port's scheduler on
``device="cpu"``).

``tas_mixed_store`` cut to 300 workloads then runs through
``run_until_quiet`` in phase 14's four ways (``solver="auto"`` or
host-only, each fill mode).
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import pytest

import torch_scheduler_pins as P
from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu_torch import features as port_features
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PortScheduler

HOST = "kubernetes.io/hostname"
BLOCK = "cloud/block"
RACK = "cloud/rack"

PACKAGES = {
    "jax": (jax_types, JaxStore, JaxQueues,
            lambda s, q: JaxScheduler(s, q)),
    "port": (port_types, PortStore, PortQueues,
             lambda s, q: PortScheduler(s, q, device="cpu")),
}


@pytest.fixture(params=["host_fill", "device_fill"])
def fill_mode(request):
    gates = {"TASDeviceFillCounts": request.param == "device_fill"}
    jax_features.set_gates(gates)
    port_features.set_gates(gates)
    yield request.param
    jax_features.reset()
    port_features.reset()


class TasHarness:
    """A TAS store (block > rack > host, 4,000 m cpu per host) with
    ClusterQueues on one TAS flavor, over one package, logging the state
    after every step."""

    def __init__(self, pkg, racks=2, hosts=2, cqs=(("cq", 16000),),
                 preemption=None, checks=(), nodes=None):
        t, store_cls, queues_cls, make = PACKAGES[pkg]
        self.t = t
        self.store = store_cls()
        self.store.upsert_topology(t.Topology(
            name="default", levels=[BLOCK, RACK, HOST]))
        self.store.upsert_resource_flavor(t.ResourceFlavor(
            name="tas-flavor", topology_name="default"))
        for name, labels, cpu in nodes or [
                (f"n-0-{r}-{h}", {BLOCK: "b0", RACK: f"b0-r{r}"}, 4000)
                for r in range(racks) for h in range(hosts)]:
            self.store.upsert_node(t.Node(name=name, labels=dict(labels),
                                          allocatable={"cpu": cpu}))
        for name, nominal in cqs:
            self.store.upsert_cluster_queue(t.ClusterQueue(
                name=name, admission_checks=list(checks),
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[t.FlavorQuotas(name="tas-flavor", resources=[
                        t.ResourceQuota(name="cpu", nominal=nominal)])])],
                preemption=(t.PreemptionPolicy() if preemption is None
                            else t.PreemptionPolicy(
                                within_cluster_queue=getattr(
                                    t.PreemptionPolicyValue, preemption)))))
            self.store.upsert_local_queue(t.LocalQueue(
                name=f"lq-{name}", cluster_queue=name))
        self.queues = queues_cls(self.store)
        self.scheduler = make(self.store, self.queues)
        self._t = 0.0
        self.log = []

    def _note(self, stats):
        self.log.append((
            None if stats is None else (stats.heads, stats.admitted,
                                        stats.preempted, stats.skipped,
                                        stats.inadmissible),
            self.scheduler.cycle_count,
            P.committed_store_digest(self.store),
            P.queue_state(self.queues),
            sorted((k, [psa.delayed_topology_request
                        for psa in w.status.admission.podset_assignments])
                   for k, w in self.store.workloads.items()
                   if w.status.admission is not None)))

    def podset(self, name="main", count=1, cpu=1000, min_count=None, **tr):
        return self.t.PodSet(
            name=name, count=count, requests={"cpu": cpu},
            min_count=min_count,
            topology_request=(self.t.PodSetTopologyRequest(**tr)
                              if tr else None))

    def submit(self, name, podsets, cq="cq", priority=0):
        self._t += 1.0
        self.store.add_workload(self.t.Workload(
            name=name, queue_name=f"lq-{cq}", priority=priority,
            creation_time=self._t, uid=len(self.store.workloads) + 1,
            podsets=podsets))

    def cycle(self, n=1):
        for _ in range(n):
            self._t += 1.0
            self.scheduler.requeue_due(self._t)
            self._note(self.scheduler.schedule(now=self._t))

    def wl(self, name):
        return self.store.workloads[f"default/{name}"]


def s_admit_writes_topology(pkg):
    h = TasHarness(pkg)
    h.submit("wl", [h.podset(count=4, required=RACK)])
    h.cycle()
    return h


def s_implied_tas_on_tas_only_cq(pkg):
    h = TasHarness(pkg)
    h.submit("wl", [h.podset(count=2)])
    h.cycle()
    return h


def s_usage_visible_next_cycle(pkg):
    h = TasHarness(pkg)
    h.submit("wl1", [h.podset(count=6, required=RACK)])
    h.submit("wl2", [h.podset(count=6, required=RACK)])
    h.cycle(2)
    return h


def s_topology_full_inadmissible(pkg):
    h = TasHarness(pkg, racks=1)
    h.submit("wl", [h.podset(count=9, required=RACK)])
    h.cycle(2)
    return h


def s_same_cycle_no_oversubscription(pkg):
    h = TasHarness(pkg, racks=1, hosts=1, cqs=(("cq", 16000),
                                                ("cq2", 16000)))
    h.submit("wl1", [h.podset(count=3, required=HOST)])
    h.submit("wl2", [h.podset(count=3, required=HOST)], cq="cq2")
    h.cycle(3)
    return h


def _group(h, workers=2, w_cpu=1000, l_cpu=1000, level=HOST):
    return [h.podset("w", count=workers, cpu=w_cpu, required=level,
                     podset_group_name="g"),
            h.podset("l", count=1, cpu=l_cpu, required=level,
                     podset_group_name="g")]


def s_same_cycle_multi_podset(pkg):
    h = TasHarness(pkg, cqs=(("cq1", 4000), ("cq2", 4000)), nodes=[
        ("n0", {BLOCK: "b0", RACK: "r0"}, 4000)])
    h.submit("wl1", [h.podset(count=2, required=HOST)], cq="cq1")
    h.submit("wl2", _group(h), cq="cq2")
    h.cycle(3)
    return h


def s_fragmentation_preemption(pkg):
    h = TasHarness(pkg, preemption="LOWER_PRIORITY")
    for i in range(2):
        h.submit(f"filler-{i}", [h.podset(count=6, required=RACK)])
    h.cycle(2)
    h.submit("big", [h.podset(count=8, required=RACK)], priority=10)
    h.cycle(6)
    return h


def s_leader_group_preempts(pkg):
    h = TasHarness(pkg, racks=2, hosts=2, cqs=(("cq", 12000),),
                   preemption="LOWER_PRIORITY")
    h.submit("low-a", [h.podset(count=4, required=RACK)])
    h.submit("low-b", [h.podset(count=4, required=RACK)])
    h.cycle(2)
    h.submit("group", _group(h, workers=5, l_cpu=2000, level=RACK),
             priority=5)
    h.cycle(6)
    return h


def s_partial_admission(pkg):
    h = TasHarness(pkg, racks=1, cqs=(("cq", 40000),))
    h.submit("elastic", [h.podset(count=12, min_count=4, required=RACK)])
    h.cycle(2)
    return h


def s_evict_clears_unhealthy(pkg):
    h = TasHarness(pkg)
    h.submit("wl", [h.podset(count=2, required=RACK)])
    h.cycle()
    h.wl("wl").status.unhealthy_nodes = ["gone-node"]
    h.scheduler.evict_workload("default/wl", reason="Test", message="",
                               now=h._t)
    assert h.wl("wl").status.unhealthy_nodes == []
    h.cycle(2)
    return h


def s_delayed_topology_second_pass(pkg):
    h = TasHarness(pkg, racks=1, hosts=2, checks=("prov",))
    h.submit("wl", [h.podset(count=4, required=RACK)])
    h.submit("wl2", [h.podset(count=5, required=RACK)])
    h.cycle(2)
    # the checks turn Ready: both go to the second pass; the rack (8
    # pods) holds wl, and wl2 retries with backoff until a node joins
    h.scheduler.queues.queue_second_pass("default/wl", h._t)
    h.scheduler.queues.queue_second_pass("default/wl2", h._t)
    h._note(None)
    h.cycle()
    h.store.upsert_node(h.t.Node(name="extra", labels={
        BLOCK: "b0", RACK: "b0-r0"}, allocatable={"cpu": 1000}))
    h.cycle(3)
    return h


SCENARIOS = {name[2:]: fn for name, fn in sorted(globals().items())
             if name.startswith("s_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, fill_mode):
    want = SCENARIOS[name]("jax")
    got = SCENARIOS[name]("port")
    assert len(got.log) == len(want.log)
    for i, (g, w) in enumerate(zip(got.log, want.log)):
        assert g == w, f"step {i}"


def test_reference_outcomes_hold(fill_mode):
    """What tests/test_tas.py asserts of the JAX scheduler, on the
    port."""
    h = s_admit_writes_topology("port")
    ta = h.wl("wl").status.admission.podset_assignments[0]
    assert sum(d.count for d in ta.topology_assignment.domains) == 4
    h = s_implied_tas_on_tas_only_cq("port")
    assert h.wl("wl").status.admission.podset_assignments[
        0].topology_assignment is not None
    h = s_usage_visible_next_cycle("port")
    racks = [{d.values[0].split("-")[2] for d in h.wl(n).status.admission
              .podset_assignments[0].topology_assignment.domains}
             for n in ("wl1", "wl2")]
    assert all(len(r) == 1 for r in racks) and racks[0] != racks[1]
    assert not s_topology_full_inadmissible("port").wl("wl").is_admitted
    h = s_same_cycle_no_oversubscription("port")
    assert sum(h.wl(n).is_admitted for n in ("wl1", "wl2")) == 1
    h = s_same_cycle_multi_podset("port")
    assert sum(h.wl(n).is_admitted for n in ("wl1", "wl2")) == 1
    h = s_fragmentation_preemption("port")
    assert h.wl("big").is_admitted
    assert any(h.wl(f"filler-{i}").is_evicted for i in range(2))
    h = s_delayed_topology_second_pass("port")
    states = [h.wl(n).status.admission.podset_assignments[0]
              .delayed_topology_request for n in ("wl", "wl2")]
    assert states == ["Ready", "Ready"]


@pytest.mark.parametrize("name,solver,fill", P.TAS_MIXED_RUNS)
def test_mixed_store_matches_jax(name, solver, fill):
    """Phase 14's four runs on tas_mixed_store cut to 300 workloads."""
    want = P.run_tas_mixed(P.jax_package(), solver=solver, fill=fill,
                           with_queues=True, n_workloads=300)
    got = P.run_tas_mixed(P.port_package("cpu"), solver=solver, fill=fill,
                          with_queues=True, n_workloads=300)
    assert got == want
    assert want["fills"] > 0
    if not solver:
        assert want["groups"] > 0
