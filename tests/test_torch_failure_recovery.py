"""The port's node-failure recovery against the JAX package.

Every scenario of tests/test_failure_recovery.py runs through both
packages' ``NodeFailureController`` on the same store (the port's
scheduler and controller on the CPU), with the TASDeviceFillCounts gate
off and on: the in-place replacement places through
``find_topology_assignments_for_workload(..., workload=)``, whose fill-in
counts the gate moves to ``solver/cuda_tas.fill_counts`` (its plain
version here). After every step the topology assignments, the
unhealthy-node lists, the eviction state and the committed-store digest
must be equal. Phase 20 (c) (the seeded flap on phase 14's mixed TAS
store) is held to the JAX package and to chip_smoke.py's pin, and the
flap injector's seeded draw to the JAX injector's.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import pytest

import torch_dispatch_pins as P
from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu_torch import features as port_features
from torch_scheduler_pins import committed_store_digest

JAX, PORT = P.JAX, P.PORT
HOST = "kubernetes.io/hostname"
BLOCK = "cloud/block"
RACK = "cloud/rack"


@pytest.fixture(autouse=True)
def _reset_gates():
    yield
    jax_features.reset()
    port_features.reset()


class Env:
    """tests/test_failure_recovery.py's Env, for either package."""

    def __init__(self, root, racks=2, hosts=2, cpu=4000, grace=30.0,
                 recovery_timeout=300.0):
        T = P._types(root)
        self.root, self.T = root, T
        self.store = P.mod(root, "core.store").Store()
        self.store.upsert_topology(T.Topology(
            name="default", levels=[BLOCK, RACK, HOST]))
        self.store.upsert_resource_flavor(T.ResourceFlavor(
            name="tas-flavor", topology_name="default"))
        for r in range(racks):
            for h in range(hosts):
                self.store.upsert_node(T.Node(
                    name=f"n-{r}-{h}", labels={BLOCK: "b0", RACK: f"r{r}"},
                    allocatable={"cpu": cpu}))
        self.store.upsert_cluster_queue(T.ClusterQueue(
            name="cq", resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="tas-flavor", resources=[
                    T.ResourceQuota(name="cpu",
                                    nominal=racks * hosts * cpu)])])]))
        self.store.upsert_local_queue(T.LocalQueue(name="lq",
                                                   cluster_queue="cq"))
        self.queues = P.mod(root, "core.queue_manager").QueueManager(
            self.store)
        self.scheduler = P.mod(root, "scheduler.scheduler").Scheduler(
            self.store, self.queues, **P._device_kw(root, "cpu"))
        self.nfc = self.controller(grace, recovery_timeout)
        self.t = 0.0

    def controller(self, grace=30.0, recovery_timeout=300.0):
        return P.mod(self.root, "controllers").NodeFailureController(
            self.store, self.scheduler, grace_period_s=grace,
            recovery_timeout_s=recovery_timeout)

    def submit_and_admit(self, name="wl", count=2, cpu=1000, uid=1):
        T = self.T
        self.t += 1.0
        wl = T.Workload(name=name, queue_name="lq", creation_time=self.t,
                        uid=uid, podsets=[T.PodSet(
                            name="main", count=count,
                            requests={"cpu": cpu},
                            topology_request=T.PodSetTopologyRequest(
                                required=BLOCK))])
        self.store.add_workload(wl)
        self.scheduler.schedule(self.t)
        assert wl.is_admitted
        return wl

    def hosts(self, wl):
        ta = wl.status.admission.podset_assignments[0].topology_assignment
        return sorted({d.values[-1] for d in ta.domains})

    def fail_node(self, name):
        node = self.store.nodes[name]
        node.ready = False
        self.store.upsert_node(node)

    def recover_node(self, name):
        node = self.store.nodes[name]
        node.ready = True
        self.store.upsert_node(node)

    def state(self, wl):
        adm = wl.status.admission
        ta = (None if adm is None else
              [(list(d.values), d.count) for d in
               adm.podset_assignments[0].topology_assignment.domains])
        return (ta, list(wl.status.unhealthy_nodes), wl.is_admitted,
                wl.is_evicted, wl.is_quota_reserved,
                sorted(self.nfc._not_ready_since),
                committed_store_digest(self.store))


def _grace(env):
    wl = env.submit_and_admit()
    victim = env.hosts(wl)[0]
    env.fail_node(victim)
    env.nfc.reconcile(env.t + 1)
    yield env.state(wl)
    env.nfc.reconcile(env.t + 31)
    yield env.state(wl)


def _replaced_in_place(env):
    wl = env.submit_and_admit(count=4, cpu=1000)
    env.fail_node(env.hosts(wl)[0])
    env.nfc.reconcile(env.t + 1)
    yield env.state(wl)
    env.nfc.reconcile(env.t + 100)
    yield env.state(wl)


def _impossible_evicts_after_timeout(env):
    wl = env.submit_and_admit(count=8, cpu=1000)
    env.fail_node(env.hosts(wl)[0])
    env.nfc.reconcile(env.t + 1)
    t_failed = env.t + 60
    env.nfc.reconcile(t_failed)
    yield env.state(wl)
    env.nfc.reconcile(t_failed + 400)
    yield env.state(wl)


def _fail_fast(env):
    wl = env.submit_and_admit(count=8, cpu=1000)
    env.fail_node(env.hosts(wl)[0])
    env.nfc.reconcile(env.t + 1)
    env.nfc.reconcile(env.t + 60)
    yield env.state(wl)


def _deleted_node(env):
    wl = env.submit_and_admit(count=2, cpu=1000)
    env.store.delete_node(env.hosts(wl)[0])
    env.nfc.reconcile(env.t + 10)
    yield env.state(wl)
    env.nfc.reconcile(env.t + 100)
    yield env.state(wl)


def _recovery(env):
    wl = env.submit_and_admit()
    victim = env.hosts(wl)[0]
    env.fail_node(victim)
    env.nfc.reconcile(env.t + 1)
    env.recover_node(victim)
    env.nfc.reconcile(env.t + 100)
    yield env.state(wl)


def _flap_pruned(env):
    wl = env.submit_and_admit(count=8, cpu=1000)
    victim = env.hosts(wl)[0]
    env.fail_node(victim)
    env.nfc.reconcile(env.t + 1)
    env.nfc.reconcile(env.t + 60)
    yield env.state(wl)
    env.recover_node(victim)
    env.nfc.reconcile(env.t + 120)
    yield env.state(wl)
    env.nfc.reconcile(env.t + 1000)
    yield env.state(wl)


def _flap_inside_grace(env):
    wl = env.submit_and_admit()
    victim = env.hosts(wl)[0]
    flapper = P.mod(env.root, "chaos").NodeFlapInjector(env.store, seed=1)
    flapper.flap_down(names=[victim])
    env.nfc.reconcile(env.t + 1)
    yield env.state(wl)
    flapper.flap_up()
    env.nfc.reconcile(env.t + 10)
    yield env.state(wl)
    env.nfc.reconcile(env.t + 1000)
    yield env.state(wl)
    flapper.flap_down(names=[victim])
    env.nfc.reconcile(env.t + 1001)
    yield env.state(wl)


def _restart(env):
    wl = env.submit_and_admit(count=8, cpu=1000)
    victim = env.hosts(wl)[0]
    env.fail_node(victim)
    wl.status.unhealthy_nodes = [victim]
    env.nfc = env.controller(30.0, 100.0)
    env.nfc.reconcile(1000.0)
    yield env.state(wl)
    env.nfc.reconcile(1150.0)
    yield env.state(wl)


def _two_workloads_multi_node(env):
    """Beyond the JAX tests: a workload spread over two failed nodes is
    never replaced and is evicted after the recovery timeout, while its
    neighbour on a healthy node keeps its placement."""
    a = env.submit_and_admit(name="a", count=6, cpu=1000, uid=1)
    b = env.submit_and_admit(name="b", count=2, cpu=1000, uid=2)
    for h in env.hosts(a)[:2]:
        env.fail_node(h)
    env.nfc.reconcile(env.t + 1)
    env.nfc.reconcile(env.t + 40)
    yield env.state(a) + env.state(b)
    env.nfc.reconcile(env.t + 400)
    yield env.state(a) + env.state(b)


SCENARIOS = {
    "grace": (dict(grace=30.0), {}, _grace),
    "replaced_in_place": (dict(racks=2, hosts=2), {}, _replaced_in_place),
    "impossible_evicts_after_timeout": (
        dict(racks=1, hosts=2, recovery_timeout=300.0), {},
        _impossible_evicts_after_timeout),
    "fail_fast": (dict(racks=1, hosts=2),
                  {"TASFailedNodeReplacementFailFast": True,
                   "TASFailedNodeReplacement": False}, _fail_fast),
    "deleted_node": (dict(racks=2, hosts=2), {}, _deleted_node),
    "recovery": ({}, {}, _recovery),
    "flap_pruned": (dict(racks=1, hosts=2, recovery_timeout=300.0),
                    {"TASFailedNodeReplacement": False}, _flap_pruned),
    "flap_inside_grace": (dict(grace=30.0), {}, _flap_inside_grace),
    "restart": (dict(racks=1, hosts=2, recovery_timeout=100.0),
                {"TASFailedNodeReplacement": False}, _restart),
    "multi_node": (dict(racks=2, hosts=4, cpu=2000), {},
                   _two_workloads_multi_node),
}


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_jax(scenario, fill):
    env_kw, gates, steps = SCENARIOS[scenario]

    def run(root):
        P.mod(root, "features").set_gates(
            {**gates, "TASDeviceFillCounts": fill})
        return list(steps(Env(root, **env_kw)))

    want = run(JAX)
    got = run(PORT)
    assert got == want
    assert len(got) >= 1


def test_flap_injector_draw_matches_jax():
    """The seeded sample over the sorted ready node names is
    ``random.Random(seed).sample``, call for call."""
    def run(root):
        env = Env(root, racks=4, hosts=8)
        inj = P.mod(root, "chaos").NodeFlapInjector(env.store, seed=11)
        out = [inj.flap_down(count=3), inj.flap_down(count=5),
               inj.flap_up(names=None), inj.flap_down(count=40)]
        return out, sorted(n for n, node in env.store.nodes.items()
                           if not node.ready)

    assert run(PORT) == run(JAX)


def test_mixed_tas_store_failure_leg_matches_jax_and_the_pin():
    """Phase 20 (c): 96 seeded nodes of phase 14's mixed TAS store down
    (29 workloads on one failed node, one on two), the controller past
    the grace period and the recovery timeout with TASDeviceFillCounts
    on: the 29 are re-placed in place, the other is evicted."""
    import chip_smoke

    want = P.node_failure_leg(JAX, *P.tas_host_store(JAX))
    fills = [0]
    from kueue_oss_tpu_torch.tas.snapshot import TASFlavorSnapshot

    real = TASFlavorSnapshot._device_fill

    def counted(self, *a, **kw):
        fills[0] += 1
        return real(self, *a, **kw)

    TASFlavorSnapshot._device_fill = counted
    try:
        got = P.node_failure_leg(PORT, *P.tas_host_store(PORT))
    finally:
        TASFlavorSnapshot._device_fill = real
    assert got == want
    assert len(got["replaced"]) == len(got["single"]) > 0
    assert got["evicted"] == got["multi"] != []
    assert fills[0] > 0, "the replacement ran the device fill path"
    assert chip_smoke.DISPATCH_REFERENCE["node_failure"] == want


def test_flap_trace_leg_matches_jax_and_the_pin():
    """Phase 20 (e): ``simulate_trace`` with two down flaps and one up
    flap on a generated lean trace whose store carries the 640 TAS
    nodes: the flap log, admissions and TTA by class."""
    import chip_smoke

    want = P.flap_trace_leg(JAX)
    got = P.flap_trace_leg(PORT)
    assert got == want
    assert [f["down"] for f in got["node_flaps"]] == [True, True, False]
    assert sorted(got["node_flaps"][2]["nodes"]) == sorted(
        got["node_flaps"][0]["nodes"] + got["node_flaps"][1]["nodes"])
    assert chip_smoke.DISPATCH_REFERENCE["flap_trace"] == want
