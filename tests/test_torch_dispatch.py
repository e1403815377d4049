"""The port's what-if-scored MultiKueue dispatch against the JAX package.

``sim/dispatch.py`` (``price_dispatch``: build_lane, the canvas
normalization, one batched lean drain, the lane scores), the three
dispatchers and the hub's ``MultiKueueController`` run on the same
seeded inputs in both packages; every report, nomination, mirror and
check state must be equal (tolerance 0). The port runs on the CPU
(``device="cpu"``); chip_smoke.py phase 20 runs it on the card against
the pins of tests/torch_dispatch_pins.py.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

import torch_dispatch_pins as P
from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu.sim import dispatch as jax_dispatch
from kueue_oss_tpu_torch import features as port_features
from kueue_oss_tpu_torch.sim import dispatch as port_dispatch

JAX, PORT = P.JAX, P.PORT


@pytest.fixture(autouse=True)
def _reset_gates():
    yield
    jax_features.reset()
    port_features.reset()


def _dev(root):
    return P._device_kw(root, "cpu")


def worker_env(root, name, quota, background_cpu=(), cohorted=False,
               preempt=False, n_cqs=1, nflavors=1, tas=False):
    """tests/test_federation.py's ``_worker_env`` (plus a TAS flavor
    case), background uids numbered from 1."""
    T = P._types(root)
    env = P.mod(root, "multikueue").WorkerEnvironment(name, **_dev(root))
    store = env.store
    if tas:
        store.upsert_topology(T.Topology(name="t", levels=["rack"]))
    for j in range(nflavors):
        store.upsert_resource_flavor(T.ResourceFlavor(
            name=f"f{j}", topology_name="t" if tas else None))
    if cohorted:
        store.upsert_cohort(T.Cohort(name="pool"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(T.ClusterQueue(
            name=f"wcq{i}", cohort="pool" if cohorted else None,
            preemption=(T.PreemptionPolicy(
                within_cluster_queue="LowerPriority") if preempt
                else T.PreemptionPolicy()),
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name=f"f{j}", resources=[
                    T.ResourceQuota(name="cpu", nominal=quota)])
                    for j in range(nflavors)])]))
        store.upsert_local_queue(T.LocalQueue(
            name=f"lq{i}" if i else "lq", cluster_queue=f"wcq{i}"))
    for i, cpu in enumerate(background_cpu):
        store.add_workload(T.Workload(
            name=f"bg{i}", queue_name="lq", creation_time=float(i),
            uid=i + 1, podsets=[T.PodSet(count=1, requests={"cpu": cpu})]))
    env.run_cycle(5.0)
    return env


#: tests/test_federation.py:442's heterogeneous forests, and more
FORESTS = {
    "lean": (4000, dict(background_cpu=(1000, 1000))),
    "wide": (3000, dict(background_cpu=(500,) * 4, cohorted=True,
                        n_cqs=3)),
    "rich": (2000, dict(background_cpu=(1500,), nflavors=2, n_cqs=2)),
    "deep": (1500, dict(background_cpu=(700, 300, 200), cohorted=True,
                        n_cqs=5, nflavors=3)),
}


def _envs(root, names):
    return {n: worker_env(root, n, FORESTS[n][0], **FORESTS[n][1])
            for n in names}


def _candidate(root, cpu=1200, uid=7, name="cand", queue="lq"):
    T = P._types(root)
    return T.Workload(name=name, queue_name=queue, creation_time=50.0,
                      uid=uid, podsets=[T.PodSet(count=1,
                                                 requests={"cpu": cpu})])


def _price(root, envs, wl, **kw):
    price = P.mod(root, "sim.dispatch").price_dispatch
    return price(wl, envs, now=51.0, check_oracle=True, **_dev(root), **kw)


@pytest.mark.parametrize("names", [("lean", "wide", "rich"),
                                   ("lean", "wide", "rich", "deep"),
                                   ("wide", "deep"), ("rich",)])
@pytest.mark.parametrize("cpu", [300, 1200, 2600])
def test_report_matches_jax_on_forests_that_differ(names, cpu):
    want = _price(JAX, _envs(JAX, names), _candidate(JAX, cpu))
    got = _price(PORT, _envs(PORT, names), _candidate(PORT, cpu))
    assert P.report_record(got) == P.report_record(want)
    assert got.oracle_identical and got.best == got.oracle_best
    assert got.batch_width == P.mod(PORT, "solver.tensors").pow2(
        len(names)) and len(got.scores) == len(names)
    assert got.host_reads == got.rounds + 1 and got.rounds > 0


def test_normalize_tensors_match_jax():
    """The canvas normalization, field by field, on the widest canvas of
    four different forests (remapped null node, inert CQs, zero
    columns)."""
    lanes = {}
    for root, dmod in ((JAX, jax_dispatch), (PORT, port_dispatch)):
        envs = _envs(root, ("lean", "wide", "rich", "deep"))
        probs = [dmod.build_lane(envs[n], _candidate(root), now=51.0)[0]
                 for n in sorted(envs)]
        W = dmod.pow2(max(p.n_workloads for p in probs))
        probs = [dmod.pad_workloads(p, W) for p in probs]
        dims = (max(p.parent.shape[0] for p in probs),
                max(p.path.shape[1] for p in probs),
                max(p.n_cqs for p in probs),
                max(p.nominal.shape[1] for p in probs),
                max(p.wl_valid.shape[1] for p in probs))
        lanes[root] = (dims, [dmod.normalize_tensors(p, *dims)
                              for p in probs])
    assert lanes[JAX][0] == lanes[PORT][0]
    for want, got in zip(lanes[JAX][1], lanes[PORT][1]):
        for f in want._fields:
            w, g = np.asarray(getattr(want, f)), getattr(got, f)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("case", ["preempt", "tas", "no_queue",
                                  "tas_candidate", "mixed"])
def test_unpriceable_reasons_match_jax(case):
    def build(root):
        T = P._types(root)
        wl = _candidate(root)
        if case == "preempt":
            envs = {"p1": worker_env(root, "p1", 4000, (500,),
                                     preempt=True),
                    "p2": worker_env(root, "p2", 4000, (500,),
                                     preempt=True)}
        elif case == "tas":
            envs = {"t": worker_env(root, "t", 4000, tas=True)}
        elif case == "no_queue":
            envs = _envs(root, ("lean", "rich"))
            wl = _candidate(root, queue="nowhere")
        elif case == "tas_candidate":
            envs = _envs(root, ("lean",))
            wl.podsets[0].topology_request = T.PodSetTopologyRequest(
                required="rack")
        else:
            envs = {**_envs(root, ("lean", "wide")),
                    "p": worker_env(root, "p", 4000, preempt=True)}
        return envs, wl

    want = _price(JAX, *build(JAX))
    got = _price(PORT, *build(PORT))
    assert P.report_record(got) == P.report_record(want)
    assert got.unpriceable
    assert (got.best is None) == (case != "mixed")


def test_price_dispatch_runs_on_cuda_by_default():
    envs = _envs(PORT, ("lean",))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dispatch.price_dispatch(_candidate(PORT), envs)
    # nothing priceable: no device is touched
    rep = port_dispatch.price_dispatch(_candidate(PORT, queue="nowhere"),
                                       envs)
    assert rep.best is None and rep.unpriceable


# ---------------------------------------------------------------------------
# the hub: dispatchers and the MultiKueue controller
# ---------------------------------------------------------------------------


class MkEnv:
    """tests/test_multikueue.py's hub and workers (each worker one
    ClusterQueue of ``quota``), for either package."""

    def __init__(self, root, worker_quotas=(8000, 8000), dispatcher=None,
                 workers=None, lost_timeout=100.0):
        T = P._types(root)
        mk = P.mod(root, "multikueue")
        self.root, self.T = root, T
        self.hub = P.mod(root, "core.store").Store()
        self._cq(self.hub, 16000, checks=["multikueue"])
        self.hub.upsert_admission_check(T.AdmissionCheck(
            name="multikueue",
            controller_name=mk.MULTIKUEUE_CONTROLLER_NAME))
        queues = P.mod(root, "core.queue_manager").QueueManager(self.hub)
        self.sched = P.mod(root, "scheduler.scheduler").Scheduler(
            self.hub, queues, **_dev(root))
        self.wr = P.mod(root, "controllers").WorkloadReconciler(
            self.hub, self.sched)
        if workers is None:
            workers = []
            for i, quota in enumerate(worker_quotas):
                env = mk.WorkerEnvironment(f"worker{i + 1}", **_dev(root))
                self._cq(env.store, quota)
                workers.append(env)
        self.workers = [mk.MultiKueueCluster(name=e.name, environment=e)
                        for e in workers]
        self.mk = mk.MultiKueueController(
            self.hub, self.sched, self.workers, dispatcher=dispatcher,
            worker_lost_timeout_s=lost_timeout)
        self.t = 0.0

    def _cq(self, store, nominal, checks=()):
        T = self.T
        store.upsert_resource_flavor(T.ResourceFlavor(name="f0"))
        store.upsert_cluster_queue(T.ClusterQueue(
            name="cq", admission_checks=list(checks),
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f0", resources=[
                    T.ResourceQuota(name="cpu", nominal=nominal)])])]))
        store.upsert_local_queue(T.LocalQueue(name="lq", cluster_queue="cq"))

    def submit(self, name="wl", cpu=1000, uid=500):
        self.t += 1.0
        self.hub.add_workload(self.T.Workload(
            name=name, queue_name="lq", creation_time=self.t, uid=uid,
            podsets=[self.T.PodSet(count=1, requests={"cpu": cpu})]))

    def tick(self, run_workers=True):
        self.t += 1.0
        self.sched.schedule(self.t)
        self.mk.reconcile_all(self.t)
        if run_workers:
            for w in self.workers:
                if w.active:
                    w.environment.run_cycle(self.t)
        self.mk.reconcile_all(self.t)
        self.wr.reconcile_all(self.t)

    def state(self, name="wl"):
        """The hub workload's dispatch state and every worker's mirror."""
        wl = self.hub.workloads.get(f"default/{name}")
        if wl is None:
            return None
        check = wl.status.admission_checks.get("multikueue")
        mirrors = {}
        for w in self.workers:
            m = w.environment.store.workloads.get(wl.key)
            mirrors[w.name] = None if m is None else (
                m.is_quota_reserved, m.is_admitted, m.is_finished,
                m.owner)
        return (wl.status.cluster_name,
                list(wl.status.nominated_cluster_names),
                None if check is None else check.state,
                wl.is_quota_reserved, wl.is_admitted, wl.is_finished,
                wl.active, mirrors)


def _race(env):
    env.submit()
    for _ in range(3):
        env.tick()
        yield env.state()


def _finish(env):
    yield from _race(env)
    wl = env.hub.workloads["default/wl"]
    winner = env.mk.clusters[wl.status.cluster_name].environment
    winner.scheduler.finish_workload(wl.key, now=env.t)
    env.tick()
    yield env.state()


def _worker_lost(env):
    yield from _race(env)
    winner = env.hub.workloads["default/wl"].status.cluster_name
    env.mk.clusters[winner].active = False
    env.tick()
    yield env.state()
    env.t += 200.0
    for _ in range(3):
        env.tick()
        yield env.state()


def _hub_eviction(env):
    yield from _race(env)
    env.sched.evict_workload("default/wl", reason="Preempted",
                             message="hub-side", now=env.t)
    env.tick(run_workers=False)
    yield env.state()


def _worker_eviction(env):
    yield from _race(env)
    winner = env.hub.workloads["default/wl"].status.cluster_name
    env.mk.clusters[winner].environment.scheduler.evict_workload(
        "default/wl", reason="Preempted", message="worker-side",
        now=env.t, requeue=True)
    env.mk.reconcile_all(env.t + 1)
    yield env.state()
    for _ in range(3):
        env.tick()
        yield env.state()


def _rejected(env):
    env.submit()
    env.sched.schedule(env.t)
    env.hub.workloads["default/wl"].status.admission_checks[
        "multikueue"].state = "Rejected"
    env.wr.reconcile_all(env.t)
    yield env.state()
    env.tick()
    yield env.state()


SCENARIOS = {"race": _race, "finish": _finish,
             "worker_lost": _worker_lost, "hub_eviction": _hub_eviction,
             "worker_eviction": _worker_eviction, "rejected": _rejected}


@pytest.mark.parametrize("redo", [True, False])
@pytest.mark.parametrize("dispatcher", ["all", "incremental", "whatif"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_hub_matches_jax(scenario, dispatcher, redo):
    def run(root):
        P.mod(root, "features").set_gates(
            {"MultiKueueRedoAdmissionOnEvictionInWorker": redo})
        mk = P.mod(root, "multikueue")
        disp = {"all": lambda: None,
                "incremental": lambda: mk.IncrementalDispatcher(
                    per_round=1, round_timeout_s=2.0),
                "whatif": lambda: P.whatif_dispatcher(root)}[dispatcher]()
        env = MkEnv(root, (3000, 8000, 2000), dispatcher=disp)
        return list(SCENARIOS[scenario](env)), disp

    want, _ = run(JAX)
    got, disp = run(PORT)
    assert got == want
    if dispatcher == "whatif":
        assert disp.faults == []
        # a rejected check deactivates the workload before any pricing
        assert (disp.counts["scored"] >= 1) == (scenario != "rejected")
        assert len(disp.score_ms) == sum(disp.counts[k] for k in (
            "scored", "fallback"))


def _dispatcher(root, kind):
    return {"all": lambda: None,
            "whatif": lambda: P.whatif_dispatcher(root)}[kind]()


@pytest.mark.parametrize("dispatcher", ["all", "whatif"])
@pytest.mark.parametrize("wait_admitted", [True, False])
def test_wait_for_admitted_gate_matches_jax(wait_admitted, dispatcher):
    """tests/test_multikueue.py's race on a worker whose ClusterQueue
    holds an admission check nobody satisfies: its mirror reserves quota
    but is never Admitted, so it wins only with
    MultiKueueWaitForWorkloadAdmitted off."""
    def run(root):
        P.mod(root, "features").set_gates(
            {"MultiKueueWaitForWorkloadAdmitted": wait_admitted})
        env = MkEnv(root, (8000,), dispatcher=_dispatcher(root, dispatcher))
        wstore = env.workers[0].environment.store
        wcq = wstore.cluster_queues["cq"]
        wcq.admission_checks = ["hold"]
        wstore.upsert_cluster_queue(wcq)
        wstore.upsert_admission_check(env.T.AdmissionCheck(name="hold"))
        env.submit()
        states = []
        for _ in range(4):
            env.tick()
            states.append(env.state())
        return states

    want = run(JAX)
    got = run(PORT)
    assert got == want
    assert got[-1][0] == (None if wait_admitted else "worker1")


def test_multikueue_gate_off_matches_jax():
    """With the MultiKueue gate off the hub mirrors nothing and its check
    stays Pending; turned on, the race runs."""
    def run(root):
        gates = P.mod(root, "features")
        gates.set_gates({"MultiKueue": False})
        env = MkEnv(root, (3000, 8000))
        env.submit()
        states = []
        for _ in range(2):
            env.tick()
            states.append(env.state())
        gates.set_gates({"MultiKueue": True})
        for _ in range(2):
            env.tick()
            states.append(env.state())
        return states

    want = run(JAX)
    got = run(PORT)
    assert got == want
    assert got[1][0] is None and all(
        m is None for m in got[1][-1].values())
    assert got[-1][0] is not None


def _fed(root, specs, dispatcher=None):
    """tests/test_federation.py's FedEnv: a hub over
    ``worker_env``-built workers."""
    workers = [worker_env(root, n, q, **kw) for n, q, kw in specs]
    return MkEnv(root, workers=workers,
                 dispatcher=dispatcher or P.whatif_dispatcher(root))


def _whatif_trace(root, specs, ticks, cpu=1000):
    env = _fed(root, specs)
    env.submit(cpu=cpu)
    trace = []
    for _ in range(ticks):
        env.tick()
        trace.append(env.state())
    rep = env.mk.dispatcher.last_reports.get("default/wl")
    return (trace, None if rep is None else P.report_record(rep),
            env.mk.dispatcher)


@pytest.mark.parametrize("case", ["best", "fallback", "defer"])
def test_whatif_nominations_match_jax(case):
    specs = {
        "best": [("tight", 2000, dict(background_cpu=(1500,))),
                 ("roomy", 8000, dict(background_cpu=(1000,))),
                 ("full", 2000, dict(background_cpu=(2000,)))],
        "fallback": [("p1", 4000, dict(background_cpu=(500,),
                                       preempt=True)),
                     ("p2", 4000, dict(background_cpu=(500,),
                                       preempt=True))],
        "defer": [("fullA", 2000, dict(background_cpu=(2000,))),
                  ("fullB", 2000, dict(background_cpu=(2000,)))],
    }[case]
    want = _whatif_trace(JAX, specs, 3)
    got = _whatif_trace(PORT, specs, 3)
    assert got[:2] == want[:2]
    disp = got[2]
    assert disp.faults == []
    if case == "best":
        assert got[0][0][0] == "roomy" and disp.counts["scored"] == 1
    elif case == "fallback":
        assert disp.counts["fallback"] >= 1
        assert set(got[1]["unpriceable"]) == {"p1", "p2"}
    else:
        assert len(got[0][0][1]) == 1 and disp.counts["deferred"] >= 1


def test_pricer_fault_degrades_and_is_recorded(monkeypatch):
    """A pricer exception still nominates (the Incremental fallback) but
    is recorded by kind, never dropped."""
    def boom(*a, **kw):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr(port_dispatch, "price_dispatch", boom)
    env = _fed(PORT, [("a", 4000, {}), ("b", 4000, {})])
    env.submit()
    env.tick()
    disp = env.mk.dispatcher
    assert disp.faults == [("RuntimeError", "CUDA error: launch failure")]
    assert disp.counts == {"scored": 0, "deferred": 0, "fallback": 1}
    assert env.hub.workloads["default/wl"].status.cluster_name in ("a", "b")


# ---------------------------------------------------------------------------
# phase 20 (a) and (b) at their full size, and chip_smoke.py's copies
# ---------------------------------------------------------------------------


def test_bench_fleet_matches_jax_and_the_pins():
    """bench.py's phase-2 fleet: time to admit of all six sizes under
    both dispatchers, the winners and every pricing's report."""
    import chip_smoke

    want = P.bench_fleet(JAX)
    got = P.bench_fleet(PORT)
    assert got == want
    assert got["agree"] == got["scored"] == len(P.BENCH_SIZES)
    assert chip_smoke.DISPATCH_REFERENCE["bench_fleet"] == want


def test_fleet_pricing_matches_jax_and_the_pins():
    """Phase 20 (b): 8 workers of Kueue's large-scale mix (forests of
    1 x 10 and 2 x 5 ClusterQueues, quotas 0.5-2x; five saturated
    with 500 pending each, three with headroom), one nomination with
    the sequential oracle. The report shows a real choice: the headroom
    workers admit the candidate in different rounds, the others park
    it."""
    import chip_smoke

    want = P.price_fleet(JAX, P.fleet_envs(JAX))
    envs = P.fleet_envs(PORT)
    got = P.price_fleet(PORT, envs)
    assert P.report_record(got) == P.report_record(want)
    assert got.oracle_identical and got.batch_width == 8
    assert [len(envs[n].store.workloads) for n in sorted(envs)] == [
        500, 500, 500, 500, 40, 25, 70, 500]
    keys = [s.key()[:3] for s in got.scores]
    assert len(set(keys)) == 4 and got.scores[0].admitted
    assert got.best == "w5" and not got.scores[-1].admitted
    assert chip_smoke.DISPATCH_REFERENCE["fleet"] == P.report_record(want)


def test_chip_smoke_copies_match_the_pins_helpers():
    """chip_smoke.py keeps its own copies of phase 20's store constructors and
    constants (port types only)."""
    import chip_smoke

    for name in ("ROUND_TIMEOUT", "BENCH_SIZES", "FLEET", "FLEET_CPU",
                 "FLEET_NOW", "FLAP_SEED", "FLAP_COUNT", "FAILURE_TIMES",
                 "DELAYED_WORKLOADS", "TRACE_FLAPS", "TRACE_SEED"):
        assert getattr(chip_smoke, name) == getattr(P, name), name
    fleet = chip_smoke.fleet_envs(device="cpu", cqs_cut=2)
    want = P.fleet_envs(PORT, cqs_cut=2)
    assert sorted(fleet) == sorted(want)
    for name in fleet:
        a, b = fleet[name].store, want[name].store
        assert sorted(a.cluster_queues) == sorted(b.cluster_queues)
        assert [(k, w.uid, w.priority, w.creation_time,
                 w.podsets[0].requests) for k, w in a.workloads.items()] \
            == [(k, w.uid, w.priority, w.creation_time,
                 w.podsets[0].requests) for k, w in b.workloads.items()]
        assert ({n: q.resource_groups for n, q in a.cluster_queues.items()}
                == {n: q.resource_groups
                    for n, q in b.cluster_queues.items()})
    assert (P.report_record(chip_smoke.fleet_candidate_report(
        fleet, device="cpu"))
        == P.report_record(P.price_fleet(PORT, want)))
    workers = chip_smoke.bench_workers(device="cpu")
    assert [(w.name, sorted(w.store.workloads)) for w in workers] == [
        (w.name, sorted(w.store.workloads))
        for w in P.bench_workers(PORT)]
    store, schedule, spec = chip_smoke.flap_trace()
    want_store, want_schedule, want_spec = P.flap_trace(PORT)
    assert spec.to_dict() == want_spec.to_dict()
    assert sorted(store.nodes) == sorted(want_store.nodes)
    assert ([(g.workload.key, g.workload.uid, g.arrival_ms)
             for g in schedule]
            == [(g.workload.key, g.workload.uid, g.arrival_ms)
                for g in want_schedule])
    d = chip_smoke.delayed_tas_store(n_workloads=40)
    w = P.delayed_tas_store(PORT, n_workloads=40)
    assert sorted(d.workloads) == sorted(w.workloads)
    assert ({n: q.admission_checks for n, q in d.cluster_queues.items()}
            == {n: q.admission_checks for n, q in w.cluster_queues.items()})
    assert sorted(d.admission_checks) == sorted(w.admission_checks)
