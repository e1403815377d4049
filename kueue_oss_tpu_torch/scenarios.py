"""The TAS drain scenario and its plan digest.

``tas_drain_store`` builds the store of the reference Kueue's TAS
scheduler performance configuration
(test/performance/scheduler/configs/tas/generator.yaml), the same shape
``bench.py``'s ``tas_drain`` scenario builds: one block of racks of
96-cpu hosts, cohorts of ClusterQueues with nominal 20 cpu and a
borrowing limit of 100 on one TAS flavor, and a backlog of 1/5/20-cpu
single-pod workloads with required / preferred / unconstrained rack
requests drawn from ``random.Random(seed)``.

The builder takes the API types module and the Store class as
arguments, so identical stores can be built for any package that has
the same object model; the draw order matches ``bench.py`` exactly.
"""

from __future__ import annotations

import hashlib
import json
import random

HOSTNAME = "kubernetes.io/hostname"
BLOCK = "cloud.provider.com/topology-block"
RACK = "cloud.provider.com/topology-rack"


def tas_drain_store(types, store_cls, *, n_racks: int = 10,
                    n_hosts: int = 64, n_cohorts: int = 5, n_cqs: int = 6,
                    n_workloads: int = 15000, seed: int = 640):
    """Build the TAS drain store (defaults: the full 640-node,
    30-ClusterQueue, 15,000-workload shape)."""
    store = store_cls()
    store.upsert_topology(types.Topology(name="default",
                                         levels=[BLOCK, RACK, HOSTNAME]))
    store.upsert_resource_flavor(types.ResourceFlavor(
        name="tas", topology_name="default"))
    for r in range(n_racks):
        for h in range(n_hosts):
            store.upsert_node(types.Node(
                name=f"n-{r}-{h}", labels={BLOCK: "b0", RACK: f"r{r}"},
                allocatable={"cpu": 96}))
    for c in range(n_cohorts):
        store.upsert_cohort(types.Cohort(name=f"co{c}"))
        for qi in range(n_cqs):
            name = f"cq-{c}-{qi}"
            store.upsert_cluster_queue(types.ClusterQueue(
                name=name, cohort=f"co{c}",
                resource_groups=[types.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[types.FlavorQuotas(name="tas", resources=[
                        types.ResourceQuota(name="cpu", nominal=20,
                                            borrowing_limit=100)])])]))
            store.upsert_local_queue(types.LocalQueue(
                name=f"lq-{c}-{qi}", cluster_queue=name))
    rng = random.Random(seed)
    mix = [1, 5, 20]
    for i in range(n_workloads):
        cpu = mix[rng.randrange(3)]
        mode = rng.randrange(3)
        tr = (types.PodSetTopologyRequest(required=RACK) if mode == 0
              else types.PodSetTopologyRequest(preferred=RACK) if mode == 1
              else types.PodSetTopologyRequest(unconstrained=True))
        c, qi = rng.randrange(n_cohorts), rng.randrange(n_cqs)
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq-{c}-{qi}", uid=i + 1,
            creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": cpu},
                                  topology_request=tr)]))
    return store


def plan_rows(store, admitted_keys) -> list:
    """One row per admitted key, in order: key, ClusterQueue, sorted
    flavors, topology levels and [[values, count], ...] domains of the
    first podset assignment."""
    rows = []
    for key in admitted_keys:
        adm = store.workloads[key].status.admission
        psa = adm.podset_assignments[0]
        ta = psa.topology_assignment
        rows.append([key, adm.cluster_queue, sorted(psa.flavors.items()),
                     ta.levels, [[d.values, d.count] for d in ta.domains]])
    return rows


def plan_digest(store, admitted_keys) -> str:
    """sha256 of the compact JSON of ``plan_rows``."""
    rows = plan_rows(store, admitted_keys)
    return hashlib.sha256(
        json.dumps(rows, separators=(",", ":")).encode()).hexdigest()
