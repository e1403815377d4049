"""The port's host-only ``Scheduler`` against the JAX one, tolerance 0.

The scenarios of ``tests/test_scheduler.py`` (priority, FIFO,
StrictFIFO, borrowing and its limits, one borrowing admission per cohort
per cycle, flavor fall-through and preference, taints,
whenCanBorrow=TryNextFlavor, preemption within a ClusterQueue and its
minimal victim set, reclaim within a cohort, the fair-sharing tournament
and fair preemption, the mid-cycle capacity flush, reactivation,
partial admission) run on identical stores of both packages through
the same calls. After every step the committed-store digest
(``tests/torch_scheduler_pins.py``), the cycle statistics, the scheduler's
cycle count and each queue's heap and parked sets must be equal. A last
test runs heads that need a host topology placement (the reduced TAS
store) through both schedulers.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import pytest

import torch_scheduler_pins as P
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PortScheduler

PACKAGES = {
    "jax": (jax_types, JaxStore, JaxQueues, JaxScheduler),
    "port": (port_types, PortStore, PortQueues, PortScheduler),
}


class Harness:
    """tests/test_scheduler.py's harness over one package, logging the
    state after every step."""

    def __init__(self, pkg, cqs, cohorts=(), flavors=("default",),
                 fair_sharing=False):
        self.t, store_cls, queues_cls, sched_cls = PACKAGES[pkg]
        self.store = store_cls()
        for f in flavors:
            self.store.upsert_resource_flavor(
                f(self.t) if callable(f) else self.t.ResourceFlavor(name=f))
        for c in cohorts:
            self.store.upsert_cohort(self.t.Cohort(name=c))
        for make in cqs:
            cq = make(self.t)
            self.store.upsert_cluster_queue(cq)
            self.store.upsert_local_queue(self.t.LocalQueue(
                name=f"lq-{cq.name}", cluster_queue=cq.name))
        self.queues = queues_cls(self.store)
        self.scheduler = sched_cls(self.store, self.queues,
                                   enable_fair_sharing=fair_sharing)
        self._t = 0.0
        self.log = []

    def _note(self, stats):
        self.log.append((
            None if stats is None else (stats.heads, stats.admitted,
                                        stats.preempted, stats.skipped,
                                        stats.inadmissible),
            self.scheduler.cycle_count,
            P.committed_store_digest(self.store),
            {n: (sorted(q._in_heap), sorted(q.inadmissible))
             for n, q in self.queues.queues.items()}))

    def submit(self, name, cq, cpu=1000, count=1, priority=0,
               min_count=None):
        self._t += 1.0
        self.store.add_workload(self.t.Workload(
            name=name, queue_name=f"lq-{cq}", priority=priority,
            creation_time=self._t, uid=len(self.store.workloads) + 1,
            podsets=[self.t.PodSet(count=count, requests={"cpu": cpu},
                                   min_count=min_count)]))

    def cycle(self):
        self._t += 1.0
        self.scheduler.requeue_due(self._t)
        self._note(self.scheduler.schedule(now=self._t))

    def settle(self, max_cycles=50):
        idle = 0
        for _ in range(max_cycles):
            pre = self.scheduler._queue_fingerprint()
            self._t += 1.0
            self.scheduler.requeue_due(self._t)
            stats = self.scheduler.schedule(now=self._t)
            if stats.heads == 0 and self.scheduler.next_requeue_at() is None:
                break
            if (stats.admitted == 0 and stats.preempted == 0
                    and self.scheduler._queue_fingerprint() == pre):
                idle += 1
                if idle > 3 and self.scheduler.next_requeue_at() is None:
                    break
                nxt = self.scheduler.next_requeue_at()
                if nxt is not None:
                    self._t = max(self._t, nxt)
            else:
                idle = 0
        self._note(None)

    def finish(self, name):
        self._t += 1.0
        self.scheduler.finish_workload(f"default/{name}", now=self._t)

    def wl(self, name):
        return self.store.workloads[f"default/{name}"]


def cq(name, nominal, cohort=None, flavors=None, **kw):
    """A ClusterQueue maker for either package; flavors: [(flavor,
    nominal)] in preference order."""
    def make(t):
        fls = flavors or [("default", nominal)]
        return t.ClusterQueue(
            name=name, cohort=cohort,
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name=f, resources=[
                    t.ResourceQuota(
                        name="cpu", nominal=n,
                        borrowing_limit=kw.get("borrowing_limit"),
                        lending_limit=kw.get("lending_limit"))])
                    for f, n in fls])],
            queueing_strategy=kw.get("strategy",
                                     t.QueueingStrategy.BEST_EFFORT_FIFO),
            preemption=_preemption(t, kw.get("preemption")),
            flavor_fungibility=(
                t.FlavorFungibility(when_can_borrow=kw["when_can_borrow"])
                if "when_can_borrow" in kw else t.FlavorFungibility()))
    return make


def _preemption(t, spec):
    if spec is None:
        return t.PreemptionPolicy()
    return t.PreemptionPolicy(**{k: getattr(t.PreemptionPolicyValue, v)
                                 for k, v in spec.items()})


LOWER = {"within_cluster_queue": "LOWER_PRIORITY"}
RECLAIM = {"reclaim_within_cohort": "ANY"}


def s_within_quota(pkg):
    h = Harness(pkg, [cq("cq", 4000)])
    h.submit("a", "cq", cpu=2000)
    h.submit("b", "cq", cpu=2000)
    h.settle()
    return h


def s_finish_then_admit(pkg):
    h = Harness(pkg, [cq("cq", 3000)])
    h.submit("a", "cq", cpu=2000)
    h.submit("b", "cq", cpu=2000)
    h.settle()
    h.finish("a")
    h.settle()
    return h


def s_priority(pkg):
    h = Harness(pkg, [cq("cq", 2000)])
    h.submit("low", "cq", cpu=2000, priority=1)
    h.submit("high", "cq", cpu=2000, priority=10)
    h.settle()
    return h


def s_fifo(pkg):
    h = Harness(pkg, [cq("cq", 2000)])
    h.submit("first", "cq", cpu=2000)
    h.submit("second", "cq", cpu=2000)
    h.settle()
    return h


def s_strict_fifo(pkg):
    h = Harness(pkg, [cq("cq", 3000, strategy="StrictFIFO"),
                      cq("other", 1000, strategy="StrictFIFO")])
    h.submit("big", "cq", cpu=4000)
    h.submit("small", "cq", cpu=1000)
    h.submit("fits", "other", cpu=1000)
    h.settle()
    return h


def s_best_effort_around_head(pkg):
    h = Harness(pkg, [cq("cq", 3000)])
    h.submit("big", "cq", cpu=4000)
    h.submit("small", "cq", cpu=1000)
    h.submit("small2", "cq", cpu=1000)
    h.settle()
    return h


def s_borrow(pkg):
    h = Harness(pkg, [cq("a", 2000, "co"), cq("b", 2000, "co")],
                cohorts=["co"])
    h.submit("w1", "a", cpu=3000)
    h.settle()
    return h


def s_borrowing_limit(pkg):
    h = Harness(pkg, [cq("a", 2000, "co", borrowing_limit=500),
                      cq("b", 2000, "co")], cohorts=["co"])
    h.submit("w1", "a", cpu=3000)
    h.submit("w2", "a", cpu=2500)
    h.settle()
    return h


def s_lending_limit(pkg):
    h = Harness(pkg, [cq("a", 2000, "co"),
                      cq("b", 2000, "co", lending_limit=500)],
                cohorts=["co"])
    h.submit("w1", "a", cpu=3000)
    h.submit("w2", "a", cpu=2400)
    h.settle()
    return h


def s_one_borrower_per_cycle(pkg):
    h = Harness(pkg, [cq("a", 0, "co"), cq("b", 0, "co"),
                      cq("idle", 3000, "co")], cohorts=["co"])
    h.submit("wa", "a", cpu=2000)
    h.submit("wb", "b", cpu=2000)
    h.cycle()
    h.settle()
    return h


def s_non_borrowers_share_cycle(pkg):
    h = Harness(pkg, [cq("a", 2000, "co"), cq("b", 2000, "co")],
                cohorts=["co"])
    h.submit("wa", "a", cpu=2000)
    h.submit("wb", "b", cpu=2000)
    h.cycle()
    return h


FLAVORED = dict(flavors=[("on-demand", 2000), ("spot", 5000)])


def s_flavor_fall_through(pkg):
    h = Harness(pkg, [cq("cq", 0, **FLAVORED)],
                flavors=("on-demand", "spot"))
    h.submit("big", "cq", cpu=4000)
    h.submit("small", "cq", cpu=1000)
    h.settle()
    return h


def s_taint(pkg):
    def spot(t):
        return t.ResourceFlavor(name="spot", node_taints=[
            t.Taint(key="spot", effect="NoSchedule")])
    h = Harness(pkg, [cq("cq", 0, **FLAVORED)],
                flavors=("on-demand", spot))
    h.submit("big", "cq", cpu=4000)
    h.submit("small", "cq", cpu=1000)
    h.settle()
    return h


def s_try_next_flavor(pkg):
    h = Harness(pkg, [
        cq("a", 0, "co", flavors=[("on-demand", 1000), ("spot", 5000)],
           when_can_borrow="TryNextFlavor"),
        cq("b", 3000, "co", flavors=[("on-demand", 3000)])],
        cohorts=["co"], flavors=("on-demand", "spot"))
    h.submit("w", "a", cpu=2000)
    h.settle()
    return h


def s_preempt_in_cq(pkg):
    h = Harness(pkg, [cq("cq", 2000, preemption=LOWER)])
    h.submit("low", "cq", cpu=2000, priority=0)
    h.settle()
    h.submit("high", "cq", cpu=2000, priority=10)
    h.settle()
    return h


def s_no_preemption_never(pkg):
    h = Harness(pkg, [cq("cq", 2000)])
    h.submit("low", "cq", cpu=2000, priority=0)
    h.settle()
    h.submit("high", "cq", cpu=2000, priority=10)
    h.settle()
    return h


def s_minimal_victims(pkg):
    h = Harness(pkg, [cq("cq", 3000, preemption=LOWER)])
    for i in range(3):
        h.submit(f"v{i}", "cq", cpu=1000, priority=i)
    h.settle()
    h.submit("high", "cq", cpu=1000, priority=10)
    h.settle()
    return h


def s_reclaim(pkg):
    h = Harness(pkg, [cq("a", 2000, "co", preemption=RECLAIM),
                      cq("b", 2000, "co")], cohorts=["co"])
    h.submit("borrower", "b", cpu=4000)
    h.settle()
    h.submit("owner", "a", cpu=2000)
    h.settle()
    return h


def s_reclaim_spares_non_borrowers(pkg):
    h = Harness(pkg, [cq("a", 2000, "co", preemption=RECLAIM),
                      cq("b", 2000, "co")], cohorts=["co"])
    h.submit("rightful", "b", cpu=2000)
    h.settle()
    h.submit("wants", "a", cpu=4000)
    h.settle()
    return h


FAIR = [cq("a", 2000, "co", preemption=RECLAIM),
        cq("b", 2000, "co", preemption=RECLAIM), cq("c", 2000, "co")]


def s_fair_tournament(pkg):
    h = Harness(pkg, FAIR, cohorts=["co"], fair_sharing=True)
    h.submit("a-pre", "a", cpu=3000)
    h.settle()
    h.submit("a-next", "a", cpu=1500)
    h.submit("b-next", "b", cpu=1500)
    h.cycle()
    h.settle()
    return h


def s_fair_preemption(pkg):
    h = Harness(pkg, FAIR, cohorts=["co"], fair_sharing=True)
    for i in range(6):
        h.submit(f"hog-{i}", "a", cpu=1000)
    h.settle()
    h.submit("claim", "b", cpu=2000)
    h.settle()
    h.submit("claim-2", "b", cpu=1500)
    h.submit("c-1", "c", cpu=1500)
    h.settle()
    return h


def s_mid_cycle_flush(pkg):
    h = Harness(pkg, [cq("a", 2000, "co", preemption=LOWER),
                      cq("b", 0, "co")], cohorts=["co"])
    h.submit("low", "a", cpu=2000, priority=0)
    h.settle()
    h.submit("high", "a", cpu=2000, priority=10)
    h.submit("b-wl", "b", cpu=2000)
    h.cycle()
    h.settle()
    return h


def s_reactivation(pkg):
    h = Harness(pkg, [cq("cq", 2000)])
    h.submit("w", "cq", cpu=1000)
    wl = h.wl("w")
    wl.active = False
    h.store.update_workload(wl)
    h.settle()
    wl.active = True
    h.store.update_workload(wl)
    h.settle()
    return h


def s_partial_admission(pkg):
    h = Harness(pkg, [cq("cq", 3000)])
    h.submit("elastic", "cq", cpu=1000, count=5, min_count=1)
    h.submit("rigid", "cq", cpu=1000, count=5, min_count=4)
    h.settle()
    return h


def s_eviction_backoff(pkg):
    """A controller eviction with an explicit backoff (PodsReady style):
    the RequeueState gate, the backoff heap, requeue_due."""
    h = Harness(pkg, [cq("cq", 2000)])
    h.submit("w", "cq", cpu=2000)
    h.submit("next", "cq", cpu=2000)
    h.settle()
    for _ in range(2):
        h._t += 1.0
        h.scheduler.evict_workload("default/w", reason="PodsReadyTimeout",
                                   message="timeout", now=h._t,
                                   backoff_base_s=5.0)
        h.cycle()
        h.settle()
    h.finish("next")
    h.settle()
    return h


def s_no_fit_hash_parks_equivalents(pkg):
    h = Harness(pkg, [cq("cq", 2000)])
    for i in range(4):
        h.submit(f"big-{i}", "cq", cpu=3000)
    h.submit("small", "cq", cpu=1000)
    h.settle()
    h.finish("small")
    h.settle()
    return h


SCENARIOS = [s_within_quota, s_finish_then_admit, s_priority, s_fifo,
             s_strict_fifo, s_best_effort_around_head, s_borrow,
             s_borrowing_limit, s_lending_limit, s_one_borrower_per_cycle,
             s_non_borrowers_share_cycle, s_flavor_fall_through, s_taint,
             s_try_next_flavor, s_preempt_in_cq, s_no_preemption_never,
             s_minimal_victims, s_reclaim, s_reclaim_spares_non_borrowers,
             s_fair_tournament, s_fair_preemption, s_mid_cycle_flush,
             s_reactivation, s_partial_admission, s_eviction_backoff,
             s_no_fit_hash_parks_equivalents]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_host_scheduler_matches_jax(scenario):
    want = scenario("jax")
    got = scenario("port")
    assert len(got.log) == len(want.log) > 0
    for i, (g, w) in enumerate(zip(got.log, want.log)):
        assert g == w, f"step {i}"
    assert got.scheduler.cycle_count == want.scheduler.cycle_count
    assert any(w.is_quota_reserved for w in want.store.workloads.values())


def test_reference_outcomes_hold():
    """The port reaches what tests/test_scheduler.py asserts of the JAX
    scheduler."""
    def admitted(h):
        return sorted(w.name for w in h.store.workloads.values()
                      if w.is_admitted and not w.is_finished)
    assert admitted(s_strict_fifo("port")) == ["fits"]
    assert admitted(s_best_effort_around_head("port")) == ["small", "small2"]
    h = s_flavor_fall_through("port")
    assert h.wl("big").status.admission.podset_assignments[0].flavors == {
        "cpu": "spot"}
    assert admitted(s_taint("port")) == ["small"]
    h = s_minimal_victims("port")
    assert [h.wl(f"v{i}").is_evicted for i in range(3)] == [
        True, False, False]
    h = s_reclaim("port")
    assert h.wl("borrower").status.conditions["Preempted"].reason == (
        "InCohortReclamation")
    h = s_mid_cycle_flush("port")
    # after the cycle that preempted "low", b-wl is back in the heap
    assert h.log[1][3]["b"] == (["default/b-wl"], [])
    h = s_partial_admission("port")
    psa = h.wl("elastic").status.admission.podset_assignments[0]
    assert (psa.count, psa.resource_usage) == (3, {"cpu": 3000})


def test_host_tas_head_admitted_as_jax():
    """The same cycle of the reduced TAS store through both host-only
    schedulers admits the same heads with the same topology
    assignments."""
    from kueue_oss_tpu_torch import scenarios

    out = {}
    for pkg in ("jax", "port"):
        t, store_cls, queues_cls, sched_cls = PACKAGES[pkg]
        store = scenarios.tas_drain_store(t, store_cls, n_racks=2,
                                          n_hosts=4, n_cohorts=1, n_cqs=2,
                                          n_workloads=10)
        stats = sched_cls(store, queues_cls(store)).schedule(now=1.0)
        out[pkg] = ((stats.heads, stats.admitted, stats.skipped),
                    P.committed_store_digest(store),
                    [w.status.admission.podset_assignments[0]
                     .topology_assignment is not None
                     for w in store.workloads.values()
                     if w.is_quota_reserved])
    assert out["port"] == out["jax"]
    assert out["jax"][0][1] > 0 and all(out["jax"][2])


def test_host_tas_head_raises():
    """With TASDeviceFillCounts on, a host TAS head on a CUDA device
    that cannot be used raises out of the cycle: the fill never falls
    back to the host roll-up. With the gate off the same scheduler
    touches no device and admits the head."""
    import torch

    from kueue_oss_tpu_torch import features, scenarios

    device = f"cuda:{torch.cuda.device_count()}"  # one past the last card
    t, store_cls, queues_cls, sched_cls = PACKAGES["port"]
    admitted = {}
    for fill in (True, False):
        store = scenarios.tas_drain_store(t, store_cls, n_racks=2,
                                          n_hosts=4, n_cohorts=1, n_cqs=2,
                                          n_workloads=10)
        sched = sched_cls(store, queues_cls(store), device=device)
        features.set_gates({"TASDeviceFillCounts": fill})
        try:
            if fill:
                with pytest.raises(RuntimeError, match="CUDA"):
                    sched.schedule(now=1.0)
            else:
                admitted[fill] = sched.schedule(now=1.0).admitted
        finally:
            features.reset()
    assert admitted[False] > 0
