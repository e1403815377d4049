"""The port's workload reconciler (the admission-check path) against the
JAX package.

Both packages' ``WorkloadReconciler`` run over their own host scheduler
on the same store: a Ready check admits, a Rejected check deactivates
and evicts without a requeue, a Retry check evicts and requeues, a CQ
without checks admits at once, and all checks Ready with a delayed
topology assignment queues the scheduler's second pass, which places
the workload (TASDeviceFillCounts off and on) before the reconciler
admits it. Every step's workload states and committed-store digest
must be equal. Phase 20 (d) (the TAS drain store at 1,500 workloads
with a check on every ClusterQueue) is held to the JAX package and to
chip_smoke.py's pin.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import pytest

import torch_dispatch_pins as P
from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu_torch import features as port_features
from torch_scheduler_pins import committed_store_digest

JAX, PORT = P.JAX, P.PORT
HOST = "kubernetes.io/hostname"


@pytest.fixture(autouse=True)
def _reset_gates():
    yield
    jax_features.reset()
    port_features.reset()


class Env:
    """One ClusterQueue with checks ``checks`` (two of them by default;
    ``tas`` puts it on a 2-rack x 2-host TAS flavor), a host scheduler
    and the reconciler."""

    def __init__(self, root, checks=("prov", "mk"), tas=False,
                 quota=8000):
        T = P._types(root)
        self.root, self.T = root, T
        self.store = P.mod(root, "core.store").Store()
        if tas:
            self.store.upsert_topology(T.Topology(
                name="t", levels=["rack", HOST]))
            for r in range(2):
                for h in range(2):
                    self.store.upsert_node(T.Node(
                        name=f"n-{r}-{h}", labels={"rack": f"r{r}"},
                        allocatable={"cpu": 2000}))
        self.store.upsert_resource_flavor(T.ResourceFlavor(
            name="f", topology_name="t" if tas else None))
        for name in checks:
            self.store.upsert_admission_check(T.AdmissionCheck(
                name=name, controller_name=f"example.com/{name}"))
        self.store.upsert_cluster_queue(T.ClusterQueue(
            name="cq", admission_checks=list(checks),
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f", resources=[
                    T.ResourceQuota(name="cpu", nominal=quota)])])]))
        self.store.upsert_local_queue(T.LocalQueue(name="lq",
                                                   cluster_queue="cq"))
        self.queues = P.mod(root, "core.queue_manager").QueueManager(
            self.store)
        self.sched = P.mod(root, "scheduler.scheduler").Scheduler(
            self.store, self.queues, **P._device_kw(root, "cpu"))
        self.wr = P.mod(root, "controllers").WorkloadReconciler(
            self.store, self.sched)
        self.t = 0.0

    def submit(self, name, cpu=1000, count=1, uid=1, rack=False):
        T = self.T
        self.store.add_workload(T.Workload(
            name=name, queue_name="lq", creation_time=self.t, uid=uid,
            podsets=[T.PodSet(
                name="main", count=count, requests={"cpu": cpu},
                topology_request=(T.PodSetTopologyRequest(required="rack")
                                  if rack else None))]))

    def set_check(self, name, check, state):
        self.store.workloads[f"default/{name}"].status.admission_checks[
            check].state = state

    def step(self, dt=1.0):
        self.t += dt
        self.sched.schedule(self.t)
        self.wr.reconcile_all(self.t)

    def state(self):
        rows = []
        for key in sorted(self.store.workloads):
            wl = self.store.workloads[key]
            adm = wl.status.admission
            rows.append((
                key, wl.active, wl.is_quota_reserved, wl.is_admitted,
                wl.is_evicted,
                sorted((n, s.state) for n, s in
                       wl.status.admission_checks.items()),
                [(e.reason, e.underlying_cause, e.count)
                 for e in wl.status.eviction_stats],
                None if wl.status.requeue_state is None else
                (wl.status.requeue_state.count,
                 wl.status.requeue_state.requeue_at),
                None if adm is None else
                [(p.delayed_topology_request,
                  None if p.topology_assignment is None else
                  [(list(d.values), d.count)
                   for d in p.topology_assignment.domains])
                 for p in adm.podset_assignments],
                self.queues.second_pass_pending(key)))
        sp = sorted(self.queues._second_pass_heap)
        return rows, sp, committed_store_digest(self.store)


def _ready(env):
    env.submit("a", uid=1)
    env.submit("b", uid=2)
    env.step()
    yield env.state()
    env.set_check("a", "prov", "Ready")
    env.step()
    yield env.state()
    env.set_check("a", "mk", "Ready")
    env.set_check("b", "prov", "Ready")
    env.step()
    yield env.state()


def _rejected(env):
    env.submit("a", uid=1)
    env.submit("b", uid=2, cpu=7500)
    env.step()
    env.set_check("a", "prov", "Ready")
    env.set_check("a", "mk", "Rejected")
    env.step()
    yield env.state()
    # the freed quota admits the next workload, the rejected one stays
    # out: deactivated, never requeued
    for _ in range(3):
        env.step()
        yield env.state()


def _retry(env):
    env.submit("a", uid=1)
    env.step()
    env.set_check("a", "prov", "Retry")
    env.step()
    yield env.state()
    env.step()
    yield env.state()


def _no_checks(env):
    env.submit("a", uid=1)
    env.submit("b", uid=2)
    env.step()
    yield env.state()


def _deactivated(env):
    env.submit("a", uid=1)
    env.step()
    env.store.workloads["default/a"].active = False
    env.wr.reconcile_all(env.t)
    yield env.state()
    env.step()
    yield env.state()


def _delayed_tas(env):
    env.submit("a", cpu=1000, count=3, uid=1, rack=True)
    env.submit("b", cpu=1000, count=2, uid=2, rack=True)
    env.submit("c", cpu=1500, count=3, uid=3, rack=True)
    env.step()
    yield env.state()
    for _ in range(4):
        # every reserved workload's checks turn Ready
        for wl in env.store.workloads.values():
            for st in wl.status.admission_checks.values():
                st.state = "Ready"
        env.step()
        yield env.state()


SCENARIOS = {"ready": ({}, _ready), "rejected": ({}, _rejected),
             "retry": ({}, _retry),
             "no_checks": (dict(checks=()), _no_checks),
             "deactivated": ({}, _deactivated),
             "delayed_tas": (dict(tas=True), _delayed_tas)}


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_admission_checks_match_jax(scenario, fill):
    kw, steps = SCENARIOS[scenario]

    def run(root):
        P.mod(root, "features").set_gates({"TASDeviceFillCounts": fill})
        return list(steps(Env(root, **kw)))

    want = run(JAX)
    got = run(PORT)
    assert got == want


def test_scenarios_reach_each_outcome():
    """The port's own view of the paths above: what each one must do."""
    rows = {s: list(steps(Env(PORT, **kw)))[-1][0]
            for s, (kw, steps) in SCENARIOS.items()}
    by_key = {s: {r[0]: r for r in v} for s, v in rows.items()}
    a = by_key["ready"]["default/a"]
    assert a[3] and a[5] == [("mk", "Ready"), ("prov", "Ready")]
    assert not by_key["ready"]["default/b"][3]  # "mk" still Pending
    rej = by_key["rejected"]["default/a"]
    assert not rej[1] and not rej[2] and rej[7] is None
    assert rej[6] == [("AdmissionCheck", "Rejected", 1)]
    assert by_key["rejected"]["default/b"][2]
    assert by_key["retry"]["default/a"][6] == [
        ("AdmissionCheck", "Retry", 1)]
    # no checks: the first cycle's admission is final at once
    assert by_key["no_checks"]["default/a"][3:6] == (True, False, [])
    assert by_key["deactivated"]["default/a"][6] == [("Deactivated", "", 1)]
    placed = [r for r in by_key["delayed_tas"].values() if r[3]]
    assert placed and all(p[0] == "Ready" and p[1]
                          for r in placed for p in r[8])


def test_evict_workload_requeue_false_skips_the_backoff():
    """``Scheduler.evict_workload``'s ``requeue`` and
    ``underlying_cause``, as in the JAX scheduler."""
    def run(root, requeue):
        env = Env(root, checks=())
        env.submit("a", uid=1)
        env.step()
        env.sched.evict_workload("default/a", reason="X", message="m",
                                 now=env.t, backoff_base_s=10.0,
                                 requeue=requeue, underlying_cause="Y")
        return env.state(), env.sched.next_requeue_at()

    for requeue in (True, False):
        assert run(PORT, requeue) == run(JAX, requeue)
    assert run(PORT, False)[1] is None and run(PORT, True)[1] == 11.0


def test_delayed_tas_leg_matches_jax_and_the_pin():
    """Phase 20 (d): 102 workloads reserve quota with the topology
    Pending, the second pass places every one, the reconciler admits."""
    import chip_smoke

    want = P.delayed_tas_leg(JAX, P.delayed_tas_store(JAX))
    got = P.delayed_tas_leg(PORT, P.delayed_tas_store(PORT))
    assert got == want
    assert got["pending_topology"] == got["placed"] == got["admitted"] > 0
    assert chip_smoke.DISPATCH_REFERENCE["delayed_tas"] == want
