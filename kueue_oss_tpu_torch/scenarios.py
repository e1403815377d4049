"""The drain scenarios of the port and their plan digests.

``tas_drain_store`` builds the store of the reference Kueue's TAS
scheduler performance configuration
(test/performance/scheduler/configs/tas/generator.yaml), the same shape
``bench.py``'s ``tas_drain`` scenario builds: one block of racks of
96-cpu hosts, cohorts of ClusterQueues with nominal 20 cpu and a
borrowing limit of 100 on one TAS flavor, and a backlog of 1/5/20-cpu
single-pod workloads with required / preferred / unconstrained rack
requests drawn from ``random.Random(seed)``.

``tas_mixed_store`` is the same cluster and queues in millicores with
both TAS mixes of ``bench.py``: the plain one and the extended one of
rack-bound and host-bound slices and leader + workers groups (two
podsets of one ``podset_group_name``). The leader groups go only to
ClusterQueues 3-5 of each cohort, so ClusterQueues 0-2 stay placeable
by the drain's device placer and the rest need the host placement.

With ``preempt=True`` every ClusterQueue also preempts
(``withinClusterQueue: LowerPriority``, ``reclaimWithinCohort: Any``),
which routes the drain through the FULL path.

``baseline_preempt_store`` builds the reference Kueue's scheduler
performance baseline (test/performance/scheduler/configs/baseline/
generator.yaml, the shape of ``GeneratorConfig.baseline()``) as a
preemption storm in two waves: every low-priority ``small`` workload
first, then the ``medium`` and ``large`` ones. ``heterogeneous_preempt_
store`` builds ``GeneratorConfig.heterogeneous``: two fungible flavors
over cpu and memory plus an accelerator resource group, with pod-group
workloads, in two waves the same way.

The builders take the API types module and the Store class as
arguments, so identical stores (names, uids, creation times) can be
built for any package that has the same object model; the TAS draw
order matches ``bench.py`` exactly.

``refused_quantity_store`` is the baseline storm with memory quotas and
requests stated in bytes, as a deployment states them (4 GiB a cpu):
no quantity scale makes them fit int32 tensors, so every drain refuses
the backlog at export and the host cycles admit it.

``StormChurn`` is the finish-and-arrive churn cycle of ``bench.py``'s
delta-session scenario (bench.py:769-800) over a store: each cycle
finishes up to ``churn`` quota-holding workloads and submits ``churn``
new single-pod ones, the steady state a deployed control plane drains in.

``streaming_store`` builds the fleet of ``bench.py``'s streaming arm
(bench.py:2153-2276): 32 ClusterQueues of one flavor (``single``) or of
two flavor options and borrow-capable cohorts (``wide``);
``streaming_ticks`` is its tick driver (arrivals every 10 ms virtual
tick, a micro-drain per tick on the streaming twin, a full drain every
100 ticks) and ``time_to_admit_ms`` its creation-to-QuotaReserved
percentiles.

``drain_placer_batch`` and ``random_placer_tree`` /
``random_placer_requests`` make inputs of the sequential TAS placer
(``cuda_tas.tas_place_sequential``) from a seed with numpy: the drain's
tree and request mix, and random trees with slices, leaders, the
least-free profile and pre-rejected rows.

``durable_storm`` and ``durable_tas`` drive ``baseline_preempt_store``
and ``tas_drain_store`` with a ``PersistenceManager`` attached (the
storm through a scheduler-backed engine, the TAS store through
``Scheduler(solver="auto")``), then close the manager and recover a
fresh store from its directory; like the builders they take the
package's classes (a ``Durable`` bundle), so the JAX package's pins and
the port's card run drive the same steps.

``dense_relax_lp`` widens a relaxed LP to more flavor-resource columns,
every column non-zero where its source column is: the LPs whose sum over
the columns shows its float order.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

HOSTNAME = "kubernetes.io/hostname"
BLOCK = "cloud.provider.com/topology-block"
RACK = "cloud.provider.com/topology-rack"


def tas_drain_store(types, store_cls, *, n_racks: int = 10,
                    n_hosts: int = 64, n_cohorts: int = 5, n_cqs: int = 6,
                    n_workloads: int = 15000, seed: int = 640,
                    preempt: bool = False):
    """Build the TAS drain store (defaults: the full 640-node,
    30-ClusterQueue, 15,000-workload shape)."""
    preemption = (types.PreemptionPolicy(
        within_cluster_queue=types.PreemptionPolicyValue.LOWER_PRIORITY,
        reclaim_within_cohort=types.PreemptionPolicyValue.ANY)
        if preempt else types.PreemptionPolicy())
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
                name=name, cohort=f"co{c}", preemption=preemption,
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


#: tas_mixed_store's plain shapes (bench.py:362-380): (pods, millicores)
TAS_PLAIN_MIX = ((2, 500), (5, 2000), (20, 5000))


def tas_mixed_store(types, store_cls, *, n_workloads: int = 15000,
                    seed: int = 641):
    """Build the mixed TAS store: 640 nodes (1 block x 10 racks x 64
    hosts) of 96,000 m cpu, 5 cohorts x 6 ClusterQueues with nominal
    20,000 m and a borrowing limit of 100,000 m, and ``n_workloads``
    workloads (15,000 by default) drawn from ``random.Random(seed)``.

    Per workload the draw takes a ClusterQueue, then a shape: in
    ClusterQueues 0-2 of a cohort one of five single-podset shapes, in
    ClusterQueues 3-5 one of six, the sixth being the leader group:

    0-2. the plain mix, 2 x 500 m, 5 x 2,000 m or 20 x 5,000 m, then
         a required-rack, preferred-rack or unconstrained request;
    3.   8 x 4,000 m as 2 rack-bound slices of 4 (required block);
    4.   8 x 4,000 m as 4 host-bound slices of 2 (required rack);
    5.   a leader (1 x 8,000 m) and 6 workers x 4,000 m, two podsets of
         one podset group, required rack.
    """
    store = store_cls()
    store.upsert_topology(types.Topology(name="default",
                                         levels=[BLOCK, RACK, HOSTNAME]))
    store.upsert_resource_flavor(types.ResourceFlavor(
        name="tas", topology_name="default"))
    for r in range(10):
        for h in range(64):
            store.upsert_node(types.Node(
                name=f"n-{r}-{h}", labels={BLOCK: "b0", RACK: f"r{r}"},
                allocatable={"cpu": 96_000}))
    for c in range(5):
        store.upsert_cohort(types.Cohort(name=f"co{c}"))
        for qi in range(6):
            name = f"cq-{c}-{qi}"
            store.upsert_cluster_queue(types.ClusterQueue(
                name=name, cohort=f"co{c}",
                resource_groups=[types.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[types.FlavorQuotas(name="tas", resources=[
                        types.ResourceQuota(name="cpu", nominal=20_000,
                                            borrowing_limit=100_000)])])]))
            store.upsert_local_queue(types.LocalQueue(
                name=f"lq-{c}-{qi}", cluster_queue=name))
    TR = types.PodSetTopologyRequest
    rng = random.Random(seed)
    for i in range(n_workloads):
        c, qi = rng.randrange(5), rng.randrange(6)
        kind = rng.randrange(5 if qi < 3 else 6)
        if kind < 3:
            pods, cpu = TAS_PLAIN_MIX[kind]
            mode = rng.randrange(3)
            tr = (TR(required=RACK) if mode == 0
                  else TR(preferred=RACK) if mode == 1
                  else TR(unconstrained=True))
            podsets = [types.PodSet(name="main", count=pods,
                                    requests={"cpu": cpu},
                                    topology_request=tr)]
        elif kind == 3:
            podsets = [types.PodSet(
                name="main", count=8, requests={"cpu": 4000},
                topology_request=TR(required=BLOCK,
                                    podset_slice_required_topology=RACK,
                                    podset_slice_size=4))]
        elif kind == 4:
            podsets = [types.PodSet(
                name="main", count=8, requests={"cpu": 4000},
                topology_request=TR(required=RACK,
                                    podset_slice_required_topology=HOSTNAME,
                                    podset_slice_size=2))]
        else:
            podsets = [
                types.PodSet(name="leader", count=1, requests={"cpu": 8000},
                             topology_request=TR(required=RACK,
                                                 podset_group_name="group")),
                types.PodSet(name="workers", count=6,
                             requests={"cpu": 4000},
                             topology_request=TR(required=RACK,
                                                 podset_group_name="group"))]
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq-{c}-{qi}", uid=i + 1,
            creation_time=float(i), podsets=podsets))
    return store


#: baseline/generator.yaml workload classes: (name, count per CQ,
#: cpu request, priority, creation interval in ms)
BASELINE_CLASSES = (("small", 350, 1, 50, 100), ("medium", 100, 5, 100, 500),
                    ("large", 50, 20, 200, 1200))
#: GeneratorConfig.heterogeneous classes: (name, count per CQ, priority,
#: creation interval in ms, [(pods, per-pod requests), ...])
HETERO_CLASSES = (
    ("small", 25, 50, 60, [(1, {"cpu": 1, "memory": 100})]),
    ("group", 10, 100, 300, [(1, {"cpu": 2, "memory": 200}),
                             (3, {"cpu": 2, "memory": 200})]),
    ("accel", 5, 150, 500, [(1, {"cpu": 2, "memory": 200, "gpu": 2}),
                            (2, {"cpu": 4, "memory": 400})]),
    ("large", 5, 200, 700, [(1, {"cpu": 10, "memory": 1000})]),
)


def _preempting_cqs(types, store, n_cohorts, cqs_per_cohort, make_groups):
    for ci in range(n_cohorts):
        store.upsert_cohort(types.Cohort(name=f"cohort-{ci}"))
        for qi in range(cqs_per_cohort):
            name = f"cq-{ci}-{qi}"
            store.upsert_cluster_queue(types.ClusterQueue(
                name=name, cohort=f"cohort-{ci}",
                preemption=types.PreemptionPolicy(
                    reclaim_within_cohort=types.PreemptionPolicyValue.ANY,
                    within_cluster_queue=(
                        types.PreemptionPolicyValue.LOWER_PRIORITY)),
                resource_groups=make_groups()))
            store.upsert_local_queue(types.LocalQueue(
                name=f"lq-{name}", cluster_queue=name))


def _waves(types, n_cohorts, cqs_per_cohort, classes, scale):
    """(arrival ms, Workload) per class instance, split into the lowest
    priority class (wave 1) and the rest (wave 2), each in arrival
    order; uids number the workloads in build order."""
    rows = []
    for ci in range(n_cohorts):
        for qi in range(cqs_per_cohort):
            cq = f"cq-{ci}-{qi}"
            for name, count, prio, interval, podsets in classes:
                for i in range(max(1, int(count * scale))):
                    rows.append((i * interval, prio, types.Workload(
                        name=f"{name}-{cq}-{i}", queue_name=f"lq-{cq}",
                        priority=prio, creation_time=i * interval / 1000.0,
                        uid=len(rows) + 1,
                        podsets=[types.PodSet(name=f"ps{j}", count=n,
                                              requests=dict(req))
                                 for j, (n, req) in enumerate(podsets)])))
    rows.sort(key=lambda r: r[0])
    low = min(r[1] for r in rows)
    return ([wl for _, p, wl in rows if p == low],
            [wl for _, p, wl in rows if p != low])


def baseline_preempt_store(types, store_cls, *, n_cohorts: int = 5,
                           cqs_per_cohort: int = 6, scale: float = 1.0):
    """The Kueue scheduler-performance baseline as a preemption storm.

    Returns (store, wave1, wave2): 5 cohorts x 6 ClusterQueues, nominal
    20 cpu with a borrowing limit of 100 on one flavor, LowerPriority
    within the ClusterQueue and Any reclaim within the cohort; per
    ClusterQueue 350 ``small`` (1 cpu, priority 50), 100 ``medium``
    (5 cpu, priority 100) and 50 ``large`` (20 cpu, priority 200)
    workloads, class counts times ``scale``. Wave 1 holds the smalls,
    wave 2 the rest; the caller adds each wave and drains."""
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="default"))

    def groups():
        return [types.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[types.FlavorQuotas(name="default", resources=[
                types.ResourceQuota(name="cpu", nominal=20,
                                    borrowing_limit=100)])])]

    _preempting_cqs(types, store, n_cohorts, cqs_per_cohort, groups)
    classes = [(name, count, prio, interval, [(1, {"cpu": cpu})])
               for name, count, cpu, prio, interval in BASELINE_CLASSES]
    return (store,) + _waves(types, n_cohorts, cqs_per_cohort, classes,
                             scale)


#: bytes of memory per cpu in ``refused_quantity_store``
GIB = 1 << 30
MEMORY_PER_CPU = 4 * GIB


def refused_quantity_store(types, store_cls, *, n_cohorts: int = 5,
                           cqs_per_cohort: int = 6, scale: float = 1.0):
    """``baseline_preempt_store`` with a second resource, memory in
    bytes (4 GiB per cpu in every quota and request), in the same
    resource group. Every quantity is a multiple of the 1-cpu request's
    gcd 1, so the 4 GiB of a small workload (2^32) stays above the
    export's int32 quantity limit: both packages' drains raise
    UnsupportedProblem ("quantities too large for int32 solver
    tensors") and the scheduler admits the backlog in host cycles.
    Returns (store, wave1, wave2)."""
    store, wave1, wave2 = baseline_preempt_store(
        types, store_cls, n_cohorts=n_cohorts,
        cqs_per_cohort=cqs_per_cohort, scale=scale)
    for name, cq in list(store.cluster_queues.items()):
        rg = cq.resource_groups[0]
        rg.covered_resources = ["cpu", "memory"]
        cpu = rg.flavors[0].resources[0]
        rg.flavors[0].resources.append(types.ResourceQuota(
            name="memory", nominal=cpu.nominal * MEMORY_PER_CPU,
            borrowing_limit=cpu.borrowing_limit * MEMORY_PER_CPU))
        store.upsert_cluster_queue(cq)
    for wl in wave1 + wave2:
        for ps in wl.podsets:
            ps.requests["memory"] = ps.requests["cpu"] * MEMORY_PER_CPU
    return store, wave1, wave2


def fair_reclaim_store(types, store_cls, *, n_cohorts: int = 5,
                       cqs_per_cohort: int = 6, scale: float = 1.0):
    """The baseline store as a fair-sharing reclamation storm.

    Returns (store, wave1, wave2) over ``baseline_preempt_store``'s
    store: wave 1 holds the smalls of ClusterQueues ``cq-*-0`` and
    ``cq-*-1``, which borrow the quota of their idle cohort members;
    wave 2 holds the medium and large workloads of ``cq-*-2``, which
    reclaim it. ClusterQueues 3 and up stay idle."""
    store, low, high = baseline_preempt_store(
        types, store_cls, n_cohorts=n_cohorts,
        cqs_per_cohort=cqs_per_cohort, scale=scale)

    def of_cqs(wls, idx):
        return [wl for wl in wls
                if int(wl.queue_name.rsplit("-", 1)[1]) in idx]

    return store, of_cqs(low, (0, 1)), of_cqs(high, (2,))


def afs_baseline_store(types, store_cls, afs_cls, *, n_cohorts: int = 5,
                       cqs_per_cohort: int = 6, scale: float = 1.0):
    """The baseline backlog under admission fair sharing.

    Returns (store, afs, backlog): ``baseline_preempt_store``'s store
    with ``AdmissionScope()`` (UsageBasedAdmissionFairSharing) on every
    ClusterQueue and two LocalQueues per ClusterQueue, ``lq-<cq>-a`` and
    ``lq-<cq>-b``; the backlog is every small workload, alternating
    between the two (even index ``-a``). ``afs`` is an ``afs_cls()`` (the
    default configuration: half-life 300 s) in which every ``-a`` queue
    was charged ``{"cpu": 20}`` at t = 0. Pass ``afs`` to the
    QueueManager and drain after adding the backlog."""
    store, low, _ = baseline_preempt_store(
        types, store_cls, n_cohorts=n_cohorts,
        cqs_per_cohort=cqs_per_cohort, scale=scale)
    afs = afs_cls()
    for name, cq in list(store.cluster_queues.items()):
        cq.admission_scope = types.AdmissionScope()
        store.upsert_cluster_queue(cq)
        for side in ("a", "b"):
            store.upsert_local_queue(types.LocalQueue(
                name=f"lq-{name}-{side}", cluster_queue=name))
        afs.record_admission(f"default/lq-{name}-a", {"cpu": 20}, 0.0)
    for wl in low:
        side = "a" if int(wl.name.rsplit("-", 1)[1]) % 2 == 0 else "b"
        wl.queue_name = f"{wl.queue_name}-{side}"
    return store, afs, low


def heterogeneous_preempt_store(types, store_cls, *, n_cohorts: int = 2,
                                cqs_per_cohort: int = 3,
                                scale: float = 1.0):
    """``GeneratorConfig.heterogeneous`` as two waves: two fungible
    flavors (on-demand, spot) over cpu+memory in one resource group, an
    accelerator resource group, multi-podset workloads; returns (store,
    wave1, wave2)."""
    store = store_cls()
    for fl in ("on-demand", "spot", "accel"):
        store.upsert_resource_flavor(types.ResourceFlavor(name=fl))
    q, bl = 20, 100
    rq = types.ResourceQuota

    def groups():
        return [
            types.ResourceGroup(
                covered_resources=["cpu", "memory"],
                flavors=[
                    types.FlavorQuotas(name="on-demand", resources=[
                        rq(name="cpu", nominal=q, borrowing_limit=bl),
                        rq(name="memory", nominal=q * 100,
                           borrowing_limit=bl * 100)]),
                    types.FlavorQuotas(name="spot", resources=[
                        rq(name="cpu", nominal=2 * q, borrowing_limit=bl),
                        rq(name="memory", nominal=2 * q * 100,
                           borrowing_limit=bl * 100)]),
                ]),
            types.ResourceGroup(
                covered_resources=["gpu"],
                flavors=[types.FlavorQuotas(name="accel", resources=[
                    rq(name="gpu", nominal=4, borrowing_limit=8)])]),
        ]

    _preempting_cqs(types, store, n_cohorts, cqs_per_cohort, groups)
    return (store,) + _waves(types, n_cohorts, cqs_per_cohort,
                             HETERO_CLASSES, scale)


class StormChurn:
    """The churn cycle of bench.py:769-800 on a filled store.

    Built after the store's waves were added: the new workloads copy the
    requests of the store's first workload, go round-robin over the
    sorted LocalQueue names of its workloads, and number their uids and
    creation times on from the largest in the store. ``cycle(c, finish)``
    finishes the first ``churn`` quota-holding, unfinished workloads in
    ``store.workloads`` order through ``finish(key, now)``, submits the
    cycle's ``churn`` arrivals and returns ``now``, at which the caller
    drains: ``t0 + c``. bench.py drains first at 0, so its cycles run at
    ``now = c``; a caller whose earlier drains ran later passes their
    time as ``t0`` to keep the clock monotone. ``types`` is the API types
    module of the store's package, so identical cycles run on either
    package's store."""

    #: cycles that let the churn settle in, then the measured ones
    WARM_CYCLES = 2
    MEASURED_CYCLES = 8

    def __init__(self, types, store, churn: int, t0: float = 0.0) -> None:
        self.types = types
        self.store = store
        self.churn = churn
        self.t0 = t0
        wls = list(store.workloads.values())
        self.lqs = sorted({w.queue_name for w in wls})
        self.requests = dict(wls[0].podsets[0].requests)
        self.uid0 = max(w.uid for w in wls) + 1
        self.t_base = max(w.creation_time for w in wls) + 1.0

    def cycle(self, c: int, finish) -> float:
        """Finish and submit cycle ``c``'s workloads; returns the time
        to drain at."""
        now = self.t0 + c
        holding = [k for k, w in self.store.workloads.items()
                   if w.is_quota_reserved and not w.is_finished]
        for key in holding[:self.churn]:
            finish(key, now)
        for j in range(self.churn):
            i = self.uid0 + c * self.churn + j
            self.store.add_workload(self.types.Workload(
                name=f"churn-{c}-{j}", queue_name=self.lqs[i % len(self.lqs)],
                uid=i, creation_time=self.t_base + c * self.churn + j,
                podsets=[self.types.PodSet(name="main", count=1,
                                           requests=dict(self.requests))]))
        return now


def storm_churn_drains(types, store, wave1, wave2, finish):
    """The drains of the baseline storm under churn, in order: yields
    (label, now) once the store holds what that drain must see. Wave 1
    at now = 100, wave 2 at 200 (chip_smoke.py's phase 6), then
    ``StormChurn`` with ``churn = n_workloads // 200`` from t0 = 200: two
    warm-up and eight measured cycles. ``finish(key, now)`` is the
    package's finish path; the caller drains after each yield."""
    for wl in wave1:
        store.add_workload(wl)
    yield "wave1", 100.0
    for wl in wave2:
        store.add_workload(wl)
    yield "wave2", 200.0
    churn = StormChurn(types, store, len(store.workloads) // 200, t0=200.0)
    for c in range(1, StormChurn.WARM_CYCLES + StormChurn.MEASURED_CYCLES
                   + 1):
        yield f"cycle{c}", churn.cycle(c, finish)


#: the streaming arm's virtual clock (bench.py:2180-2181): a 10 ms tick
#: and a full solve every 100 ticks (1 s)
STREAM_TICK_S = 0.01
STREAM_SOLVE_EVERY = 100
#: the streaming arm's fleet size (bench.py:2180's default)
STREAM_CQS = 32


def streaming_store(types, store_cls, *, profile: str = "single"):
    """The fleet of bench.py's streaming arm (bench.py:2183-2223):
    ``single`` is ``STREAM_CQS`` standalone ClusterQueues with one flavor
    (nominal 10,000,000 cpu); ``wide`` makes every even ClusterQueue a
    standalone one with two flavor options (``small`` before ``large``)
    and every odd one a borrow-capable member of cohort ``co{c // 8}``,
    so every admission rides the flavor-pick witness or the
    reserved-headroom walk. One LocalQueue ``lq{c}`` per ClusterQueue."""
    store = store_cls()
    for f in ("default", "small", "large"):
        store.upsert_resource_flavor(types.ResourceFlavor(name=f))

    def quota(flavor):
        return types.FlavorQuotas(name=flavor, resources=[
            types.ResourceQuota(name="cpu", nominal=10_000_000)])

    if profile == "wide":
        for c in range(0, STREAM_CQS, 8):
            store.upsert_cohort(types.Cohort(name=f"co{c // 8}"))
    for c in range(STREAM_CQS):
        if profile == "wide" and c % 2 == 0:
            cq = types.ClusterQueue(name=f"cq{c}", resource_groups=[
                types.ResourceGroup(covered_resources=["cpu"],
                                    flavors=[quota("small"),
                                             quota("large")])])
        else:
            cq = types.ClusterQueue(
                name=f"cq{c}",
                cohort=f"co{c // 8}" if profile == "wide" else None,
                resource_groups=[types.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[quota("default")])])
        store.upsert_cluster_queue(cq)
        store.upsert_local_queue(
            types.LocalQueue(name=f"lq{c}", cluster_queue=f"cq{c}"))
    return store


def streaming_ticks(types, store, sched, *, ticks: int = 400,
                    per_tick: int = 16, stream: bool = True,
                    solve_every: int = STREAM_SOLVE_EVERY):
    """The streaming arm's tick driver (bench.py:2233-2254) as a
    generator: a full drain at t = 0 arms the fences; then per tick
    ``micro_drain(now)`` first when ``stream`` (it picks up the previous
    tick's arrivals: one tick of pickup latency), then the tick's
    ``per_tick`` arrivals round-robin over the ClusterQueues, and every
    ``solve_every`` ticks (bench.py: 100; tests cut it with the ticks) a
    full ``drain(now, verify=True)`` on the scheduler's solver engine.
    Yields ``("micro", tick, MicroDrainResult)`` after each micro-drain
    and ``("boundary", tick, DrainResult)`` after each full drain, so a
    caller can hold twins in step."""
    n_cqs = len(store.cluster_queues)
    engine = sched._solver_engine()
    engine.drain(now=0.0, verify=True)
    uid = 1
    for tick in range(1, ticks + 1):
        now = tick * STREAM_TICK_S
        if stream:
            yield "micro", tick, sched.micro_drain(now)
        for j in range(per_tick):
            c = (tick * per_tick + j) % n_cqs
            store.add_workload(types.Workload(
                name=f"w{uid}", queue_name=f"lq{c}", uid=uid,
                creation_time=now,
                podsets=[types.PodSet(count=1, requests={"cpu": 100})]))
            uid += 1
        if tick % solve_every == 0:
            yield "boundary", tick, engine.drain(now=now, verify=True)


def time_to_admit_ms(store) -> dict:
    """Virtual time-to-admit of the quota-holding workloads, creation to
    the QuotaReserved transition (bench.py:2256-2267): the count, p50
    and p95 in ms rounded to 3 places (None when nothing holds quota)."""
    waits = sorted(
        c.last_transition_time - wl.creation_time
        for wl in store.workloads.values()
        if (c := wl.status.conditions.get("QuotaReserved")) is not None
        and c.status)

    def pct(p):
        return (round(waits[int(p * (len(waits) - 1))] * 1000, 3)
                if waits else None)

    return {"admitted": len(waits), "tta_ms_p50": pct(0.50),
            "tta_ms_p95": pct(0.95)}


def preempt_plan_rows(store, result) -> list:
    """The FULL drain's plan as rows: each admitted key in order with
    its ClusterQueue and the flavors of every podset, then each evicted
    key in order with its Preempted reason."""
    rows = []
    for key in result.admitted_keys:
        adm = store.workloads[key].status.admission
        rows.append([key, adm.cluster_queue,
                     [sorted(psa.flavors.items())
                      for psa in adm.podset_assignments]])
    for key in result.evicted_keys:
        cond = store.workloads[key].status.conditions["Preempted"]
        rows.append([key, cond.reason])
    return rows


def preempt_plan_digest(store, result) -> str:
    """sha256 of the compact JSON of ``preempt_plan_rows``."""
    return hashlib.sha256(json.dumps(
        preempt_plan_rows(store, result),
        separators=(",", ":")).encode()).hexdigest()


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


#: the sequential placer's per-podset inputs, in argument order
PLACER_INPUTS = ("per_pod", "count", "level", "required", "unconstrained",
                 "least_free", "slice_size", "slice_level",
                 "leader_per_pod", "has_leader")


def random_placer_tree(n_levels: int, seed: int, *, min_children: int = 1,
                       max_children: int = 4, cap_hi: int = 24):
    """A random lex-ordered tree (nondecreasing parent arrays) and a
    random leaf capacity [D, R] (R in 1..3). With ``min_children=0``
    some inner domains have no children."""
    rng = np.random.default_rng(seed)
    parents = [np.zeros(int(rng.integers(1, 3)), np.int32)]
    for _ in range(1, n_levels):
        n_up = parents[-1].shape[0]
        kids = rng.integers(min_children, max_children + 1, size=n_up)
        kids[int(rng.integers(0, n_up))] = max(1, kids.max())
        parents.append(np.repeat(np.arange(n_up), kids).astype(np.int32))
    R = int(rng.integers(1, 4))
    cap = rng.integers(0, cap_hi, size=(parents[-1].shape[0], R)).astype(
        np.int32)
    return parents, cap


def random_placer_requests(rng, n_levels: int, R: int, M: int, *,
                           pre_rejected: float = 0.0) -> dict:
    """M random requests the host pre-checks would accept (required,
    preferred or unconstrained; slices; leaders; least-free), stacked
    per input. A share ``pre_rejected`` of rows is zeroed the way
    ``DeviceTASPlacer.place_batch`` zeroes rows the host rejected."""
    leaf = n_levels - 1
    rows = []
    for _ in range(M):
        level = int(rng.integers(0, n_levels))
        slice_level = int(rng.integers(level, n_levels))
        slice_size = int(rng.integers(1, 4))
        count = slice_size * int(rng.integers(1, 6))
        unconstrained = bool(rng.integers(0, 4) == 0)
        required = (not unconstrained) and bool(rng.integers(0, 2))
        if unconstrained:
            level = slice_level = leaf
        has_leader = bool(rng.integers(0, 2))
        row = dict(
            per_pod=rng.integers(0, 4, size=R).astype(np.int32),
            count=np.int32(count), level=np.int32(level),
            required=np.bool_(required),
            unconstrained=np.bool_(unconstrained),
            least_free=np.bool_(unconstrained and bool(rng.integers(0, 2))),
            slice_size=np.int32(slice_size),
            slice_level=np.int32(slice_level),
            leader_per_pod=(rng.integers(0, 3, size=R)
                            * has_leader).astype(np.int32),
            has_leader=np.bool_(has_leader))
        if rng.random() < pre_rejected:
            row.update(count=np.int32(0), slice_size=np.int32(1),
                       per_pod=np.zeros(R, np.int32))
        rows.append(row)
    return _stack(rows, R)


def _stack(rows: list, R: int) -> dict:
    empty = {"per_pod": (0, R), "leader_per_pod": (0, R)}
    out = {}
    for k in PLACER_INPUTS:
        if rows:
            out[k] = np.stack([np.asarray(r[k]) for r in rows])
        else:
            dtype = bool if k in ("required", "unconstrained", "least_free",
                                  "has_leader") else np.int32
            out[k] = np.zeros(empty.get(k, (0,)), dtype=dtype)
    return out


def drain_placer_batch(M: int = 102, seed: int = 640, *, n_racks: int = 10,
                       n_hosts: int = 64):
    """The drain's placement batch shape: the 1 x n_racks x n_hosts tree
    of ``tas_drain_store`` with (cpu, pods) = (96, 110) free on every
    host, and M single-pod requests drawn like its workloads (cpu in
    {1, 5, 20}; required rack, preferred rack or unconstrained; no
    slices, no leader, BestFit). Returns (parents, capacity, requests)."""
    rng = np.random.default_rng(seed)
    parents = [np.zeros(1, np.int32), np.zeros(n_racks, np.int32),
               np.repeat(np.arange(n_racks), n_hosts).astype(np.int32)]
    cap = np.tile(np.asarray([[96, 110]], np.int32), (n_racks * n_hosts, 1))
    rows = []
    for _ in range(M):
        mode = int(rng.integers(0, 3))
        rows.append(dict(
            per_pod=np.asarray([[1, 5, 20][int(rng.integers(0, 3))], 0],
                               np.int32),
            count=np.int32(1), level=np.int32(1 if mode < 2 else 2),
            required=np.bool_(mode == 0), unconstrained=np.bool_(mode == 2),
            least_free=np.bool_(False), slice_size=np.int32(1),
            slice_level=np.int32(2),
            leader_per_pod=np.zeros(2, np.int32),
            has_leader=np.bool_(False)))
    return parents, cap, _stack(rows, 2)


def dense_relax_lp(lp, n_cols: int, seed: int):
    """``lp`` (a numpy RelaxLP of either package) with its request,
    slack and scale columns tiled out to ``n_cols`` and each new column
    scaled by a seeded factor in [0.5, 2): every column of a live row is
    non-zero where the source column is, so the order of the sum over
    the columns decides the last bit of x."""
    rng = np.random.default_rng(seed)
    cols = [k % lp.r.shape[-1] for k in range(n_cols)]
    fac = rng.uniform(0.5, 2.0, size=n_cols).astype(np.float32)
    r = (lp.r[..., cols] * fac).astype(np.float32)
    r = np.where(lp.r[..., cols] > 0, np.maximum(r, np.float32(1e-3)), r)
    slack = (lp.slack[..., cols] * fac).astype(np.float32)
    scale = np.maximum(slack, np.float32(1.0)).astype(np.float32)
    return lp._replace(r=r, slack=slack, scale=scale)


#: the pull each row of ``interior_relax_lp`` gets, and the iteration
#: whose rho its score balances
INTERIOR_PULL = 0.05
INTERIOR_BALANCE = 16


def interior_relax_lp(lp, n_cols: int, seed: int, iters: int = 32):
    """A dense LP (``dense_relax_lp``) whose prices stay positive and
    whose x stays interior for all ``iters`` iterations, so that the
    last bits of the pull's sum over the ``n_cols`` columns reach x.

    Every slack is 0 and every scale 2^-20, so each node carrying load
    is over capacity at the clip: its price is exactly 1 for as long as
    its load stays positive, whatever x is. Each live row's request is
    scaled below 1 (so its normalised request is the request itself)
    until its pull, the sum over the columns of request times price, is
    ``INTERIOR_PULL``; its score is set so that ``ALPHA * s`` balances
    ``rho * pull`` at iteration ``INTERIOR_BALANCE``. Then x rises from
    0.5 while rho is below that iteration's and falls after it, staying
    in (0.5, 0.5 + 6.4 * pull) at 32 iterations: interior, its gradient
    a difference of two near-equal products, and one ulp of the pull
    moves x's rounding."""
    from kueue_oss_tpu_torch.solver import relax

    d = dense_relax_lp(lp, n_cols, seed)
    r = d.r.astype(np.float64)
    live = np.asarray(d.live)
    # the load's full charge: which nodes carry load once x > 0
    C = d.cq_node.shape[-1]
    N1 = d.parent.shape[-1]
    cq_load = np.zeros((C + 1, n_cols))
    np.add.at(cq_load, np.minimum(d.wl_cqid, C), r * live[:, None])
    u = np.zeros((N1, n_cols))
    u[d.cq_node] = cq_load[:C]
    d_max = d.path_cq.shape[-1]
    for lvl in range(d_max - 1, 0, -1):
        rows = np.nonzero(d.depth == lvl)[0]
        keep = rows[(d.parent[rows] >= 0) & (d.parent[rows] < N1)]
        np.add.at(u, d.parent[keep], u[keep])
    price = (u > 0)[d.path_cq].sum(axis=1)           # [C, F]
    rows_price = price[np.minimum(d.wl_cqid, C - 1)]
    pull0 = (r * rows_price).sum(axis=1)
    factor = np.where(live & (pull0 > 0),
                      INTERIOR_PULL / np.maximum(pull0, 1e-30), 0.0)
    r = (r * factor[:, None]).astype(np.float32)
    pull = (r.astype(np.float64) * rows_price).sum(axis=1)
    rho = float(relax._rho(INTERIOR_BALANCE, iters))
    s = np.where(live, rho * pull / relax.ALPHA, 0.0).astype(np.float32)
    return d._replace(
        r=r, s=s, slack=np.zeros_like(d.slack),
        scale=np.full_like(d.scale, np.float32(2.0 ** -20)))


@dataclass
class Durable:
    """One package's classes for ``durable_storm`` / ``durable_tas``."""

    types: Any
    store_cls: Any
    queues_cls: Any
    scheduler_cls: Any
    engine_cls: Any
    manager_cls: Any
    auditor_cls: Any
    canonical_dump: Callable
    #: keyword arguments of every Scheduler and SolverEngine built here,
    #: and attributes set on every engine (its arms' switches)
    sched_kw: dict
    engine_kw: dict
    engine_attrs: dict
    #: called after each timed step (``torch.cuda.synchronize`` on the
    #: card)
    sync: Callable = lambda: None


def _recover(pkg: Durable, dir_path: str, live: bytes, out: dict) -> None:
    """Close-time half of the durable runs: recover a fresh store
    from ``dir_path``, time it, audit it and compare its dump."""
    m2 = pkg.manager_cls(dir_path)
    t0 = time.perf_counter()
    rr = m2.recover()
    out["recovery_ms"] = (time.perf_counter() - t0) * 1000
    recovered = pkg.canonical_dump(rr.store)
    out["recovered_identical"] = recovered == live
    out["recovery"] = rr.to_dict()
    out["audit_violations"] = len(pkg.auditor_cls(rr.store).audit())
    m2.close()
    out["dump_sha256"] = hashlib.sha256(live).hexdigest()
    out["dump_bytes"] = len(live)


def durable_storm(pkg: Durable, dir_path: str, *, finish: int = 100,
                  hook: Callable = None, **store_kw) -> dict:
    """The baseline storm with the durable control plane on, as
    bench.py's durability scenario attaches it (bench.py:1349-1364):
    wave 1 seeds the store, the manager attaches (batch group commit,
    no checkpoint cadence), wave 1 drains; wave 2 arrives and a full
    checkpoint is taken over the whole store; wave 2 drains; the first
    ``finish`` admitted workloads finish (bench.py's slice of
    ``store._admitted``) and a third drain writes the WAL a tail; then
    flush, close and recover. ``hook(i, store)`` runs just before drain
    ``i`` and ``hook(i, store, result)`` just after it, untimed (the
    card run's plan checks). Returns each drain's result and wall, the
    checkpoint's and the recovery's ms, the WAL's records and bytes (the
    manager's segments summed) and the dump's sha256."""
    store, wave1, wave2 = baseline_preempt_store(pkg.types, pkg.store_cls,
                                                 **store_kw)
    queues = pkg.queues_cls(store)
    sched = pkg.scheduler_cls(store, queues, **pkg.sched_kw)
    engine = pkg.engine_cls(store, queues, scheduler=sched, **pkg.engine_kw)
    for k, v in pkg.engine_attrs.items():
        setattr(engine, k, v)
    for wl in wave1:
        store.add_workload(wl)
    manager = pkg.manager_cls(dir_path, fsync="batch",
                              checkpoint_interval_records=1 << 62,
                              checkpoint_interval_seconds=0.0)
    manager.attach(store)
    out: dict = {"workloads_seeded": len(store.workloads), "drains": []}
    wal_records = wal_bytes = 0

    def drain(now: float):
        i = len(out["drains"])
        if hook is not None:
            hook(i, store)
        t0 = time.perf_counter()
        result = engine.drain(now=now)
        pkg.sync()
        out["drains"].append((result, time.perf_counter() - t0))
        if hook is not None:
            hook(i, store, result)

    drain(100.0)
    for wl in wave2:
        store.add_workload(wl)
    out["workloads_checkpointed"] = len(store.workloads)
    wal_records += manager.wal.records_appended
    wal_bytes += manager.wal.bytes_appended
    t0 = time.perf_counter()
    manager.checkpoint()
    out["checkpoint_ms"] = (time.perf_counter() - t0) * 1000
    drain(200.0)
    finished = list(store._admitted)[:finish]
    for key in finished:
        sched.finish_workload(key, now=250.0)
    out["finished"] = len(finished)
    drain(300.0)
    manager.flush()
    wal_records += manager.wal.records_appended
    wal_bytes += manager.wal.bytes_appended
    out["wal_records"], out["wal_bytes"] = wal_records, wal_bytes
    out["checkpoint_bytes"] = sum(
        os.path.getsize(os.path.join(dir_path, n))
        for n in os.listdir(dir_path) if n.endswith(".ckpt"))
    live = pkg.canonical_dump(store)
    manager.close()
    _recover(pkg, dir_path, live, out)
    out["store"] = store
    return out


def durable_tas(pkg: Durable, dir_path: str, *, n_workloads: int = 1500,
                now: float = 0.0, tick: float = 0.001) -> dict:
    """The TAS drain store through ``Scheduler(solver="auto")`` with the
    durable control plane attached after seeding (batch group commit)
    and a full checkpoint of the seeded store (the seed never reaches
    the WAL): ``run_until_quiet(now, tick)``, then flush, close and
    recover. Returns the cycles, the wall, the last drain, the
    checkpoint's ms, the WAL's records and bytes and the recovery's
    record."""
    store = tas_drain_store(pkg.types, pkg.store_cls,
                            n_workloads=n_workloads)
    manager = pkg.manager_cls(dir_path, fsync="batch",
                              checkpoint_interval_records=1 << 62,
                              checkpoint_interval_seconds=0.0)
    manager.attach(store)
    t0 = time.perf_counter()
    manager.checkpoint()
    checkpoint_ms = (time.perf_counter() - t0) * 1000
    sched = pkg.scheduler_cls(store, pkg.queues_cls(store), solver="auto",
                              **pkg.sched_kw)
    engine = sched._solver_engine()
    for k, v in pkg.engine_attrs.items():
        setattr(engine, k, v)
    t0 = time.perf_counter()
    cycles = sched.run_until_quiet(now=now, tick=tick)
    pkg.sync()
    out = {"cycles": cycles, "wall_s": time.perf_counter() - t0,
           "drain": getattr(sched, "last_drain", None), "sched": sched,
           "checkpoint_ms": checkpoint_ms}
    manager.flush()
    out["wal_records"] = manager.wal.records_appended
    out["wal_bytes"] = manager.wal.bytes_appended
    live = pkg.canonical_dump(store)
    manager.close()
    _recover(pkg, dir_path, live, out)
    out["store"] = store
    return out
