"""Synthetic cluster + workload generator.

A copy of ``kueue_oss_tpu/perf/generator.py`` on the port's types and
store: the same config builds the same store and arrival schedule
(names, priorities, requests, creation times, runtimes) in either
package. Config shape mirrors the reference's generator.yaml
(test/performance/scheduler/configs/*/generator.yaml): cohorts ×
queue-sets × workload-sets, each workload class with request size,
priority, and runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    PreemptionPolicy,
    PreemptionPolicyValue,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from kueue_oss_tpu_torch.core.store import Store


@dataclass
class WorkloadClass:
    class_name: str
    count: int
    request: int            # cpu units per workload
    priority: int
    runtime_ms: int
    creation_interval_ms: int = 0
    #: optional heterogeneous shape: explicit podsets as
    #: [(pod_count, {resource: per-pod quantity}), ...]; overrides
    #: ``request`` when set
    podsets: list | None = None


@dataclass
class GeneratorConfig:
    """Reference parity: baseline/generator.yaml shape."""

    n_cohorts: int = 5
    cqs_per_cohort: int = 6
    nominal_quota: int = 20
    borrowing_limit: int | None = 100
    reclaim_within_cohort: str = PreemptionPolicyValue.ANY
    within_cluster_queue: str = PreemptionPolicyValue.LOWER_PRIORITY
    #: heterogeneous mode: two fungible flavors over cpu+memory plus an
    #: accelerator resource group (see GeneratorConfig.heterogeneous)
    hetero: bool = False
    classes: list[WorkloadClass] = field(default_factory=lambda: [
        WorkloadClass("small", 350, 1, 50, 200, 100),
        WorkloadClass("medium", 100, 5, 100, 500, 500),
        WorkloadClass("large", 50, 20, 200, 1000, 1200),
    ])

    @classmethod
    def baseline(cls) -> "GeneratorConfig":
        """test/performance/scheduler/configs/baseline: 5x6 CQs, 15k wl."""
        return cls()

    @classmethod
    def heterogeneous(cls, n_cohorts: int = 10,
                      cqs_per_cohort: int = 50) -> "GeneratorConfig":
        """Contended multi-flavor / multi-resource-group / multi-podset
        shape: two fungible flavors (on-demand, spot) over cpu+memory in
        one resource group, an accelerator resource group, pod-group
        workloads (driver + workers), and preemption enabled — the
        option-group axis and flavor walk the degenerate large-scale
        shape never exercises.
        """
        return cls(
            n_cohorts=n_cohorts,
            cqs_per_cohort=cqs_per_cohort,
            hetero=True,
            classes=[
                WorkloadClass("small", 25, 1, 50, 150, 60, podsets=[
                    (1, {"cpu": 1, "memory": 100})]),
                WorkloadClass("group", 10, 0, 100, 350, 300, podsets=[
                    (1, {"cpu": 2, "memory": 200}),
                    (3, {"cpu": 2, "memory": 200})]),
                WorkloadClass("accel", 5, 0, 150, 500, 500, podsets=[
                    (1, {"cpu": 2, "memory": 200, "gpu": 2}),
                    (2, {"cpu": 4, "memory": 400})]),
                WorkloadClass("large", 5, 0, 200, 700, 700, podsets=[
                    (1, {"cpu": 10, "memory": 1000})]),
            ],
        )

    @classmethod
    def large_scale(cls, preemption: bool = True) -> "GeneratorConfig":
        """configs/large-scale: 10 cohorts x 100 CQs = 1000 CQs, 50k wl."""
        return cls(
            n_cohorts=10,
            cqs_per_cohort=100,
            reclaim_within_cohort=(PreemptionPolicyValue.ANY if preemption
                                   else PreemptionPolicyValue.NEVER),
            within_cluster_queue=(PreemptionPolicyValue.LOWER_PRIORITY
                                  if preemption
                                  else PreemptionPolicyValue.NEVER),
            classes=[
                WorkloadClass("small", 35, 1, 50, 150, 60),
                WorkloadClass("medium", 11, 5, 100, 350, 300),
                WorkloadClass("large", 4, 20, 200, 700, 700),
            ],
        )


@dataclass
class GeneratedWorkload:
    workload: Workload
    class_name: str
    runtime_ms: int
    arrival_ms: float


def generate(config: GeneratorConfig) -> tuple[Store, list[GeneratedWorkload]]:
    """Build the store (CQs/cohorts/LQs/flavor) and the arrival schedule.

    Workloads are NOT added to the store; the simulator feeds them in at
    their arrival times (or all at once for backlog-drain benchmarks).
    """
    store = Store()
    if config.hetero:
        for fl in ("on-demand", "spot", "accel"):
            store.upsert_resource_flavor(ResourceFlavor(name=fl))
        q = config.nominal_quota
        bl = config.borrowing_limit

        def make_groups():
            return [
                ResourceGroup(
                    covered_resources=["cpu", "memory"],
                    flavors=[
                        FlavorQuotas(name="on-demand", resources=[
                            ResourceQuota(name="cpu", nominal=q,
                                          borrowing_limit=bl),
                            ResourceQuota(name="memory", nominal=q * 100,
                                          borrowing_limit=(
                                              None if bl is None
                                              else bl * 100)),
                        ]),
                        FlavorQuotas(name="spot", resources=[
                            ResourceQuota(name="cpu", nominal=2 * q,
                                          borrowing_limit=bl),
                            ResourceQuota(name="memory",
                                          nominal=2 * q * 100,
                                          borrowing_limit=(
                                              None if bl is None
                                              else bl * 100)),
                        ]),
                    ],
                ),
                ResourceGroup(
                    covered_resources=["gpu"],
                    flavors=[FlavorQuotas(name="accel", resources=[
                        ResourceQuota(name="gpu", nominal=4,
                                      borrowing_limit=8)])],
                ),
            ]
    else:
        store.upsert_resource_flavor(ResourceFlavor(name="default"))
        make_groups = None
    schedule: list[GeneratedWorkload] = []
    for ci in range(config.n_cohorts):
        store.upsert_cohort(Cohort(name=f"cohort-{ci}"))
        for qi in range(config.cqs_per_cohort):
            cq_name = f"cq-{ci}-{qi}"
            store.upsert_cluster_queue(ClusterQueue(
                name=cq_name,
                cohort=f"cohort-{ci}",
                preemption=PreemptionPolicy(
                    reclaim_within_cohort=config.reclaim_within_cohort,
                    within_cluster_queue=config.within_cluster_queue,
                ),
                resource_groups=(make_groups() if make_groups
                                 else [ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[FlavorQuotas(name="default", resources=[
                        ResourceQuota(
                            name="cpu",
                            nominal=config.nominal_quota,
                            borrowing_limit=config.borrowing_limit)])],
                )]),
            ))
            store.upsert_local_queue(
                LocalQueue(name=f"lq-{cq_name}", cluster_queue=cq_name))
            for wc in config.classes:
                for i in range(wc.count):
                    arrival = i * wc.creation_interval_ms
                    if wc.podsets is not None:
                        podsets = [
                            PodSet(name=f"ps{j}", count=cnt,
                                   requests=dict(reqs))
                            for j, (cnt, reqs) in enumerate(wc.podsets)]
                    else:
                        podsets = [PodSet(count=1,
                                          requests={"cpu": wc.request})]
                    wl = Workload(
                        name=f"{wc.class_name}-{cq_name}-{i}",
                        queue_name=f"lq-{cq_name}",
                        priority=wc.priority,
                        creation_time=arrival / 1000.0,
                        podsets=podsets,
                    )
                    schedule.append(GeneratedWorkload(
                        workload=wl, class_name=wc.class_name,
                        runtime_ms=wc.runtime_ms, arrival_ms=arrival))
    schedule.sort(key=lambda g: g.arrival_ms)
    return store, schedule
