"""The port's streaming admission against the JAX package's, tolerance 0.

``Scheduler(streaming=True)`` of both packages runs the scripts and
seeds of ``tests/test_streaming.py`` (the oracle-parity replay
``_gen_script``, the device micro-solve bursts ``_micro_burst_script``
with the micro-solve on and off, the wide-fence replay ``_gen_mf_script``),
the fence cases of its ``TestContentionFences`` and ``TestWideFences``,
and a cut of chip_smoke.py phase 15's tick driver
(``tests/torch_streaming_pins.py``). After every ``micro_drain`` and
every full-drain boundary the timestamped store digest (the committed
store plus each workload's QuotaReserved transition time), each queue's
heap and parked sets, the micro-drain's outcome and the stream counts
(the port's ``StreamingAdmitter.counts`` against the JAX stream
metrics) must be equal. In the port alone the stream twin must equal
the batch twin at every boundary, the micro-solve twin the host-walk
twin after every step, and the micro-solve must have reached the lean
drain (``micro_batch > 0``). ``serve`` runs with its watch-driven
worker on both packages. The JAX side of every script runs once per
module.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import threading
import time

import pytest
import torch

import torch_scheduler_pins as P
import torch_streaming_pins as S
from test_streaming import _gen_mf_script, _gen_script, _micro_burst_script

JAX = S.jax_package()
PORT = S.port_package("cpu")


@pytest.fixture(autouse=True)
def _reset_jax_observability():
    """The JAX runs feed the JAX package's process-wide metrics,
    recorder, cycle ledger and SLO windows (the serve cases with
    wall-clock waits); later test files in this process must not see
    them."""
    yield
    from kueue_oss_tpu import metrics, obs

    metrics.reset_all()
    obs.recorder.clear()
    obs.cycle_ledger.clear()
    obs.slo_engine.reset()
    obs.phase_regression.reset()


# ---------------------------------------------------------------------------
# stores of either package (tests/test_streaming.py's builders)
# ---------------------------------------------------------------------------


def make_cq(t, name, nominal, cohort=None, strategy=None, preempt=False,
            bl=None):
    return t.ClusterQueue(
        name=name, cohort=cohort,
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources=[
                t.ResourceQuota(name="cpu", nominal=nominal,
                                borrowing_limit=bl)])])],
        queueing_strategy=(strategy
                           or t.QueueingStrategy.BEST_EFFORT_FIFO),
        preemption=(t.PreemptionPolicy(
            within_cluster_queue="LowerPriority") if preempt
            else t.PreemptionPolicy()))


def make_mf_cq(t, name, nominal_small, nominal_large, cohort=None,
               bl=None):
    return t.ClusterQueue(
        name=name, cohort=cohort,
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[
                t.FlavorQuotas(name="small", resources=[
                    t.ResourceQuota(name="cpu", nominal=nominal_small,
                                    borrowing_limit=bl)]),
                t.FlavorQuotas(name="large", resources=[
                    t.ResourceQuota(name="cpu", nominal=nominal_large,
                                    borrowing_limit=bl)]),
            ])],
        queueing_strategy=t.QueueingStrategy.BEST_EFFORT_FIFO,
        preemption=t.PreemptionPolicy())


def build_store(pkg, cqs, cohorts=()):
    t = pkg.types
    store = pkg.Store()
    for f in ("default", "small", "large"):
        store.upsert_resource_flavor(t.ResourceFlavor(name=f))
    store.upsert_node(t.Node(name="n1", allocatable={"cpu": 100000}))
    for c in cohorts:
        store.upsert_cohort(t.Cohort(name=c))
    for cq in cqs:
        store.upsert_cluster_queue(cq)
        store.upsert_local_queue(
            t.LocalQueue(name=f"lq-{cq.name}", cluster_queue=cq.name))
    return store


def submit(pkg, store, name, cq, t, uid, cpu=500, prio=0):
    store.add_workload(pkg.types.Workload(
        name=name, queue_name=f"lq-{cq}", priority=prio,
        creation_time=t, uid=uid,
        podsets=[pkg.types.PodSet(count=1, requests={"cpu": cpu})]))


def parity_topology(t):
    return ([make_cq(t, "a", 3_000, cohort="co", bl=0),
             make_cq(t, "b", 2_000, cohort="co", bl=0),
             make_cq(t, "c", 2_500),
             make_cq(t, "d", 1_500, cohort="co2"),
             make_cq(t, "e", 1_500, cohort="co2")], ["co", "co2"])


def mf_parity_topology(t):
    return ([make_mf_cq(t, "m1", 2_000, 3_000),
             make_cq(t, "m2", 1_500, cohort="mco"),
             make_cq(t, "m3", 1_500, cohort="mco"),
             make_mf_cq(t, "m4", 1_000, 2_000, cohort="mco2"),
             make_cq(t, "m5", 1_500, cohort="mco2")], ["mco", "mco2"])


class Run:
    """One package's run of a script: the scheduler, and a trace of the
    state after every micro-drain and every boundary."""

    def __init__(self, pkg, cqs, cohorts=(), streaming=True) -> None:
        pkg.reset()
        self.pkg = pkg
        self.store = build_store(pkg, cqs, cohorts)
        self.queues, self.sched, self.eng = pkg.make(self.store, streaming)
        self.trace = []
        self.micro_entries = 0

    @property
    def sa(self):
        return self.sched._streaming_admitter()

    def submit(self, name, cq, t, uid, cpu=500, prio=0):
        submit(self.pkg, self.store, name, cq, t, uid, cpu=cpu, prio=prio)

    def _log(self, kind, outcome):
        self.trace.append((kind, outcome,
                           S.timed_store_digest(self.store),
                           S.queue_state(self.queues),
                           self.pkg.counts(self.sched)))

    def micro(self, now):
        res = self.sched.micro_drain(now)
        self.micro_entries += res.micro_batch
        self._log("micro", (res.admitted, res.parked, res.deferred_cqs,
                            res.micro_batch, list(res.admitted_keys)))
        return res

    def drain(self, now):
        res = self.eng.drain(now=now, verify=True)
        self._log("boundary", (res.admitted, list(res.admitted_keys)))
        return res

    def boundaries(self):
        return [e[2] for e in self.trace if e[0] == "boundary"]


# ---------------------------------------------------------------------------
# the scripts of tests/test_streaming.py
# ---------------------------------------------------------------------------


def _replay(pkg, script, streaming, topology, cohort, bl):
    cqs, cohorts = topology(pkg.types)
    run = Run(pkg, cqs, cohorts, streaming)
    run.drain(99.0)  # boundary 0 arms the fences
    flap_down = False
    for k, window in enumerate(script):
        now = 100.0 + k
        for ev in window:
            if ev[0] == "arrive":
                _, cq, name, uid, cpu, prio = ev
                run.submit(name, cq, 10.0 + uid, uid, cpu=cpu, prio=prio)
            elif ev[0] == "finish":
                run.sched.finish_workload(ev[1], now=now)
            elif ev[0] == "quota":
                run.store.upsert_cluster_queue(make_cq(
                    pkg.types, ev[1], ev[2], cohort=cohort, bl=bl))
            elif ev[0] == "flap":
                flap_down = not flap_down
                run.store.upsert_node(pkg.types.Node(
                    name="n1", allocatable={"cpu": 100000},
                    ready=not flap_down))
            if streaming:
                run.micro(now)
        run.drain(now)
    return run


def run_twin(pkg, seed, streaming):
    return _replay(pkg, _gen_script(seed), streaming, parity_topology,
                   cohort="co", bl=0)


def run_mf_twin(pkg, seed, streaming):
    return _replay(pkg, _gen_mf_script(seed), streaming,
                   mf_parity_topology, cohort="mco", bl=None)


def run_micro_twin(pkg, seed, micro):
    cqs, cohorts = parity_topology(pkg.types)
    cqs.append(make_cq(pkg.types, "s", 3_000,
                       strategy=pkg.types.QueueingStrategy.STRICT_FIFO))
    run = Run(pkg, cqs, cohorts)
    run.drain(99.0)
    run.sa.micro_solve = micro
    run.sa.micro_solve_min = 1  # every burst through the device path
    for k, window in enumerate(_micro_burst_script(seed)):
        now = 100.0 + k
        for cq, name, uid, cpu, prio in window:
            run.submit(name, cq, 10.0 + uid, uid, cpu=cpu, prio=prio)
        run.micro(now)
        run.drain(now)
    return run


# ---------------------------------------------------------------------------
# the fence cases of TestStreamingFastPath, TestContentionFences and
# TestWideFences (same steps; the trace holds every outcome)
# ---------------------------------------------------------------------------


def case_subcycle(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 10_000)])
    run.submit("w0", "a", 1.0, 1)
    run.drain(100.0)
    run.submit("w1", "a", 2.0, 2)
    run.submit("w2", "a", 3.0, 3)
    run.micro(100.5)
    return run


def case_parked_no_fit(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 1_000)])
    run.drain(100.0)
    run.submit("big", "a", 1.0, 1, cpu=5_000)
    run.submit("ok", "a", 2.0, 2, cpu=500)
    run.micro(100.5)
    return run


def case_strict_fifo(pkg):
    run = Run(pkg, [make_cq(
        pkg.types, "s", 1_000,
        strategy=pkg.types.QueueingStrategy.STRICT_FIFO)])
    run.drain(100.0)
    run.submit("big", "s", 1.0, 1, cpu=5_000)
    run.submit("ok", "s", 2.0, 2, cpu=500)
    run.micro(100.5)
    return run


def case_borrow_fence(pkg):
    run = Run(pkg, *parity_topology(pkg.types))
    run.drain(100.0)
    run.submit("xd", "d", 1.0, 1, cpu=2_000)  # needs borrow
    run.submit("xe", "e", 2.0, 2, cpu=500)
    run.micro(100.5)
    run.submit("xa", "a", 3.0, 3, cpu=500)
    run.submit("xb", "b", 4.0, 4, cpu=500)
    run.submit("xc", "c", 5.0, 5, cpu=500)
    run.micro(100.6)
    run.drain(101.0)
    return run


def case_headroom(pkg):
    run = Run(pkg, *parity_topology(pkg.types))
    run.drain(100.0)
    run.submit("yd", "d", 1.0, 1, cpu=1_000)
    run.submit("ye", "e", 2.0, 2, cpu=1_200)
    run.micro(100.5)
    run.submit("yd2", "d", 3.0, 3, cpu=600)
    run.micro(100.6)
    run.drain(101.0)
    return run


def case_capacity_event(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 1_000)])
    run.submit("w0", "a", 1.0, 1, cpu=1_000)
    run.drain(100.0)
    run.sched.finish_workload("default/w0", now=100.2)
    run.submit("w1", "a", 2.0, 2, cpu=900)
    run.micro(100.5)
    run.drain(101.0)
    run.submit("w2", "a", 3.0, 3, cpu=50)
    run.micro(101.5)
    return run


def case_preemption_cq(pkg):
    run = Run(pkg, [make_cq(pkg.types, "p", 10_000, preempt=True)])
    run.drain(100.0)
    run.submit("w1", "p", 1.0, 1)
    run.micro(100.5)
    return run


def case_spec_edit(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 10_000)])
    run.drain(100.0)
    run.store.upsert_cluster_queue(make_cq(pkg.types, "a", 9_000))
    run.submit("w1", "a", 1.0, 1)
    run.micro(100.5)
    # the edit asks for the full solve to be pulled forward, once
    run.trace.append(("request", run.sa.consume_full_solve_request(),
                      run.sa.consume_full_solve_request()))
    run.drain(101.0)
    return run


def case_out_of_order(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 10_000)])
    run.drain(100.0)
    run.submit("lo", "a", 1.0, 1, prio=0)
    run.micro(100.2)
    run.submit("hi", "a", 2.0, 2, prio=9)
    run.micro(100.4)
    run.drain(101.0)
    return run


def case_multi_flavor_stable(pkg):
    run = Run(pkg, [make_mf_cq(pkg.types, "m", 1_000, 10_000)])
    run.drain(100.0)
    run.submit("w1", "m", 1.0, 1, cpu=500)
    run.micro(100.2)
    run.submit("w2", "m", 2.0, 2, cpu=2_000)
    run.micro(100.4)
    return run


def case_witness_invalidation(pkg):
    run = Run(pkg, [make_mf_cq(pkg.types, "m", 1_000, 10_000)])
    run.drain(100.0)
    run.submit("w1", "m", 1.0, 1, cpu=600)
    run.micro(100.2)
    run.submit("w2", "m", 2.0, 2, cpu=800)
    run.micro(100.4)
    run.drain(101.0)
    run.submit("w3", "m", 3.0, 3, cpu=5_000)
    run.micro(101.2)
    return run


def case_merged_walk(pkg):
    t = pkg.types
    run = Run(pkg, [make_mf_cq(t, "m4", 1_000, 2_000, cohort="mx"),
                    make_cq(t, "m5", 1_500, cohort="mx")], ["mx"])
    run.drain(100.0)
    run.submit("a1", "m4", 1.0, 1, cpu=800)
    run.submit("a2", "m5", 2.0, 2, cpu=1_000)
    run.micro(100.5)
    return run


def case_eligible_fraction(pkg):
    t = pkg.types
    run = Run(pkg, [make_mf_cq(t, "m4", 1_000, 2_000, cohort="mx"),
                    make_cq(t, "m5", 1_500, cohort="mx"),
                    make_cq(t, "p", 5_000, preempt=True)], ["mx"])
    run.drain(100.0)
    run.submit("b1", "m4", 1.0, 1, cpu=500)
    run.submit("b2", "m5", 2.0, 2, cpu=500)
    run.micro(100.5)
    run.submit("b3", "p", 3.0, 3, cpu=500)
    run.submit("b4", "m4", 4.0, 4, cpu=100)
    run.micro(100.7)
    return run


CASES = {f.__name__[5:]: f for f in (
    case_subcycle, case_parked_no_fit, case_strict_fifo, case_borrow_fence,
    case_headroom, case_capacity_event, case_preemption_cq, case_spec_edit,
    case_out_of_order, case_multi_flavor_stable, case_witness_invalidation,
    case_merged_walk, case_eligible_fraction)}

SEEDS = (7, 23)
MF_SEEDS = (11, 29, 41)
#: the cut tick driver: 32 ClusterQueues, 8 ticks of 128 (single) or 16
#: (wide) arrivals, a full drain every 4 ticks
TICKS = {"single": (128, ("micro", "host", "batch")),
         "wide": (16, ("stream", "batch"))}


def run_ticks(pkg, profile, twin):
    return S.run_ticks(pkg, profile, twin, per_tick=TICKS[profile][0],
                       ticks=8, solve_every=4)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's traces of every script, case and tick run."""
    out = {}
    for seed in SEEDS:
        for streaming in (True, False):
            out["twin", seed, streaming] = run_twin(JAX, seed, streaming)
        for micro in (True, False):
            out["micro", seed, micro] = run_micro_twin(JAX, seed, micro)
    for seed in MF_SEEDS:
        out["mf", seed] = run_mf_twin(JAX, seed, True)
    for name, case in CASES.items():
        out["case", name] = case(JAX)
    for profile, (_, twins) in TICKS.items():
        for twin in twins:
            out["ticks", profile, twin] = run_ticks(JAX, profile, twin)
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_replay_matches_jax_after_every_step(jax_runs, seed):
    run = run_twin(PORT, seed, True)
    want = jax_runs["twin", seed, True]
    assert len(run.trace) == len(want.trace)
    for k, (got, exp) in enumerate(zip(run.trace, want.trace)):
        assert got == exp, f"seed {seed}: step {k} ({got[0]}) differs"
    # the parity must not be vacuous: arrivals streamed sub-cycle
    assert run.sa.counts["stream_admitted_total"] >= 3


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_twin_equals_batch_twin_at_boundaries(jax_runs, seed):
    stream = run_twin(PORT, seed, True)
    batch = run_twin(PORT, seed, False)
    assert stream.boundaries() == batch.boundaries()
    assert batch.boundaries() == jax_runs["twin", seed, False].boundaries()


@pytest.mark.parametrize("micro", [True, False], ids=["micro", "host"])
@pytest.mark.parametrize("seed", SEEDS)
def test_micro_burst_matches_jax(jax_runs, seed, micro):
    run = run_micro_twin(PORT, seed, micro)
    want = jax_runs["micro", seed, micro]
    assert len(run.trace) == len(want.trace)
    for k, (got, exp) in enumerate(zip(run.trace, want.trace)):
        assert got == exp, f"seed {seed}: step {k} ({got[0]}) differs"
    if micro:
        # the micro-solve reached the lean drain
        assert run.micro_entries > 0 and run.sa._micro_hwm >= 64
    else:
        assert run.micro_entries == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_micro_solve_equals_host_walk(seed):
    micro = run_micro_twin(PORT, seed, True)
    host = run_micro_twin(PORT, seed, False)
    assert micro.micro_entries > 0 and host.micro_entries == 0
    # store and queues after every micro-drain and boundary
    assert ([e[2:4] for e in micro.trace]
            == [e[2:4] for e in host.trace])


@pytest.mark.parametrize("seed", MF_SEEDS)
def test_wide_fence_replay_matches_jax(jax_runs, seed):
    run = run_mf_twin(PORT, seed, True)
    want = jax_runs["mf", seed]
    assert len(run.trace) == len(want.trace)
    for k, (got, exp) in enumerate(zip(run.trace, want.trace)):
        assert got == exp, f"seed {seed}: step {k} ({got[0]}) differs"
    batch = run_mf_twin(PORT, seed, False)
    assert run.boundaries() == batch.boundaries()
    if seed == 11:
        assert run.sa.counts["stream_admitted_total"] >= 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_fence_case_matches_jax(jax_runs, name):
    run = CASES[name](PORT)
    assert run.trace == jax_runs["case", name].trace


def test_fence_cases_fence_as_the_reference_says(jax_runs):
    """The facts tests/test_streaming.py asserts, on the port's runs
    (the traces above equal the JAX ones, so these hold for both)."""
    def micro(run, i):
        return [e[1] for e in run.trace if e[0] == "micro"][i]

    def demotions(run):
        return run.sa.counts["stream_demotions_total"]

    run = CASES["subcycle"](PORT)
    assert micro(run, 0)[0] == 2
    run = CASES["parked_no_fit"](PORT)
    assert micro(run, 0)[:2] == (1, 1)
    run = CASES["strict_fifo"](PORT)
    assert micro(run, 0)[:2] == (0, 0)
    run = CASES["borrow_fence"](PORT)
    assert micro(run, 0)[0] == 0 and micro(run, 1)[0] == 3
    assert demotions(run)["headroom_exhausted"] >= 1
    assert run.store.workloads["default/xe"].is_admitted
    run = CASES["headroom"](PORT)
    assert micro(run, 0)[0] == 2 and micro(run, 1)[0] == 0
    assert run.store.workloads["default/yd2"].is_admitted
    run = CASES["capacity_event"](PORT)
    assert micro(run, 0)[0] == 0 and micro(run, 1)[0] == 1
    assert demotions(run)["cohort_event"] >= 1
    run = CASES["preemption_cq"](PORT)
    assert micro(run, 0)[0] == 0 and micro(run, 0)[2] == 1
    assert not run.sa._static_eligible("p")
    run = CASES["spec_edit"](PORT)
    assert micro(run, 0)[0] == 0 and demotions(run)["spec_change"] >= 1
    assert ("request", True, False) in run.trace
    assert run.store.workloads["default/w1"].is_admitted
    run = CASES["out_of_order"](PORT)
    assert micro(run, 1)[0] == 0 and demotions(run)["out_of_order"] >= 1
    run = CASES["witness_invalidation"](PORT)
    assert micro(run, 1)[0] == 0 and micro(run, 2)[0] == 1
    assert demotions(run)["flavor_witness_invalid"] >= 1
    run = CASES["merged_walk"](PORT)
    assert micro(run, 0)[0] == 2
    run = CASES["eligible_fraction"](PORT)
    assert 0.0 < run.sa.counts["stream_eligible_fraction"] < 1.0


@pytest.mark.parametrize("profile,twin", [
    (p, t) for p, (_, twins) in TICKS.items() for t in twins])
def test_tick_driver_matches_jax(jax_runs, profile, twin):
    got = run_ticks(PORT, profile, twin)
    assert got == jax_runs["ticks", profile, twin]
    if twin == "micro":
        assert got["micro_solves"] > 0 and got["micro_entries"] > 0


def test_tick_driver_twins_agree(jax_runs):
    micro = jax_runs["ticks", "single", "micro"]
    host = jax_runs["ticks", "single", "host"]
    assert micro["boundaries"] == host["boundaries"]
    for profile, stream in (("single", "micro"), ("wide", "stream")):
        s = run_ticks(PORT, profile, stream)
        b = run_ticks(PORT, profile, "batch")
        assert s["committed"] == b["committed"]
        assert s["admitted"] == b["admitted"] == s["workloads"]
        assert s["tta_ms_p95"] < b["tta_ms_p95"]


# -- serve and its watch-driven worker ---------------------------------------


def _serve(run, body):
    """Run ``body`` while ``run.sched.serve`` runs in a thread; the
    serve thread must end within its timeout."""
    stop = threading.Event()
    t = threading.Thread(target=run.sched.serve, args=(stop,),
                         kwargs={"poll": 0.01}, daemon=True)
    t.start()
    try:
        body()
    finally:
        stop.set()
        t.join(timeout=10.0)
    assert not t.is_alive()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def serve_wires_watch_worker(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 10_000)])
    run.drain(100.0)
    sa = run.sa

    def body():
        assert _wait(lambda: sa._notify is not None)
        run.submit("w1", "a", 1.0, 1)
        assert _wait(lambda: run.store.workloads[
            "default/w1"].is_quota_reserved)

    _serve(run, body)
    assert sa._notify is None  # serve cleans up its notifier
    return run


def watch_drain_coalesces_burst(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 50_000)])
    run.drain(100.0)
    sa = run.sa
    stop = threading.Event()
    wake = threading.Event()
    sa.set_arrival_notifier(wake.set)
    args = (sa, wake, stop)
    if pkg is JAX:
        args += (time.monotonic,)
    t = threading.Thread(target=run.sched._watch_drain_loop, args=args,
                         daemon=True)
    t.start()
    try:
        # burst while the cycle lock is held: the worker cannot drain
        # mid-burst, so the signals coalesce
        with run.sched._cycle_mu:
            for i in range(6):
                run.submit(f"burst{i}", "a", 1.0 + i, 10 + i)
        assert _wait(lambda: pkg.counts(run.sched)[
            "stream_admitted_total"] >= 6)
    finally:
        stop.set()
        wake.set()
        t.join(timeout=10.0)
    assert not t.is_alive()
    counts = pkg.counts(run.sched)
    assert counts["stream_admitted_total"] == 6
    # 6 signals collapsed into at most 2 drains -> >= 4 coalesced
    assert counts["stream_demotions_total"]["watch_coalesced"] >= 4
    return run


def serve_pulls_full_solve_forward(pkg):
    run = Run(pkg, [make_cq(pkg.types, "a", 1_000)])
    run.drain(100.0)
    run.submit("big", "a", 1.0, 1, cpu=5_000)
    assert run.micro(100.5).parked == 1
    before = pkg.counts(run.sched)["stream_spec_solves_total"]

    def body():
        run.store.upsert_cluster_queue(make_cq(pkg.types, "a", 10_000))
        assert _wait(lambda: run.store.workloads[
            "default/big"].is_quota_reserved)

    _serve(run, body)
    assert (pkg.counts(run.sched)["stream_spec_solves_total"]
            >= before + 1)
    return run


@pytest.mark.parametrize("scenario", [
    serve_wires_watch_worker, watch_drain_coalesces_burst,
    serve_pulls_full_solve_forward], ids=lambda f: f.__name__)
def test_serve_matches_jax(scenario):
    port = scenario(PORT)
    jax = scenario(JAX)
    # real-time clocks stamp the transitions, so compare the committed
    # store without them
    assert (P.committed_store_digest(port.store)
            == P.committed_store_digest(jax.store))
    assert all(w.is_quota_reserved for w in port.store.workloads.values())


# -- the surface ------------------------------------------------------------


def test_streaming_arguments():
    from kueue_oss_tpu_torch.config import StreamingConfig
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    store = build_store(PORT, [make_cq(PORT.types, "a", 1_000)])
    for streaming in (True, StreamingConfig(enabled=True)):
        sched = Scheduler(store, QueueManager(store), solver="auto",
                          streaming=streaming, device="cpu")
        assert sched._streaming_admitter() is not None
        assert sched._solver_engine().streaming is sched._streaming_instance
    # the master switch off: the cycle-batch model
    sched = Scheduler(store, QueueManager(store), solver="auto",
                      streaming=StreamingConfig(enabled=False), device="cpu")
    assert sched._streaming_admitter() is None and sched.micro_drain() is None
    from kueue_oss_tpu_torch.config import SolverBackendConfig

    # the mesh mode reaches the engine (the CPU is one device: no mesh
    # without virtual devices); the pod-scale coordinator is item 9b
    meshed = Scheduler(store, QueueManager(store), solver="auto",
                       device="cpu",
                       solver_config=SolverBackendConfig(mesh="8"))
    assert meshed._solver_engine().mesh_mode == "8"
    assert meshed._solver_engine()._mesh() is None
    with pytest.raises(NotImplementedError, match="item 9b"):
        SolverBackendConfig(coordinator_address="host:1234")
    sched = Scheduler(store, QueueManager(store), solver="auto",
                      streaming=True, device="cpu",
                      solver_config=SolverBackendConfig(relax_audit_every=2))
    assert sched._solver_engine().relax_audit_every == 2
    assert sched._streaming_admitter() is not None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(store, QueueManager(store), solver="auto",
                  streaming=True)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_refused_drain_stops_attributing_events(pkg):
    """A drain that raises UnsupportedProblem is no boundary: the
    window stays unarmed, and the solve thread is cleared, so a later
    commit on this thread fences as any other event."""
    from kueue_oss_tpu_torch import scenarios

    store, wave1, _ = scenarios.refused_quantity_store(
        pkg.types, pkg.Store, n_cohorts=1, cqs_per_cohort=2, scale=0.02)
    _queues, sched, eng = pkg.make(store, True)
    sa = sched._streaming_admitter()
    for wl in wave1:
        store.add_workload(wl)
    with pytest.raises(Exception, match="int32"):
        eng.drain(now=100.0, verify=True)
    assert sa._solve_thread is None and not sa.armed
    assert sched.micro_drain(100.5).admitted == 0


def test_flavor_option_ceilings_match_jax():
    from kueue_oss_tpu.solver.tensors import (
        flavor_option_ceilings as jax_ceilings,
    )
    from kueue_oss_tpu_torch.solver.tensors import flavor_option_ceilings

    stores = []
    for pkg in (JAX, PORT):
        cqs, cohorts = mf_parity_topology(pkg.types)
        cqs.append(make_cq(pkg.types, "z", 700, cohort="mco", bl=300))
        stores.append(build_store(pkg, cqs, cohorts))
    assert flavor_option_ceilings(stores[1]) == jax_ceilings(stores[0])


def test_backoff_matches_jax():
    from kueue_oss_tpu.util.primitives import Backoff as JaxBackoff
    from kueue_oss_tpu_torch.util.primitives import Backoff

    for kw in ({"initial": 0.002, "cap": 0.05},
               {"initial": 0.1, "factor": 3.0},
               {"initial": 0.002, "cap": 0.05, "factor": 2.0}):
        a = Backoff(**kw)
        b = JaxBackoff(**kw)
        assert ([a.wait_time(i) for i in range(8)]
                == [b.wait_time(i) for i in range(8)])
    with pytest.raises(ValueError):
        Backoff(initial=0.0)


def test_queue_manager_condition():
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager

    store = build_store(PORT, [make_cq(PORT.types, "a", 1_000),
                               make_cq(PORT.types, "b", 1_000)])
    qm = QueueManager(store)
    assert not qm.wait_for_pending(timeout=0.01)
    assert qm.cqs_with_pending() == []
    woke = []
    t = threading.Thread(
        target=lambda: woke.append(qm.wait_for_pending(timeout=10.0)))
    t.start()
    submit(PORT, store, "w1", "b", 1.0, 1)
    t.join(timeout=10.0)
    assert not t.is_alive() and woke == [True]
    assert qm.cqs_with_pending() == ["b"]
    # wakeup releases a waiter without pending work
    qm.queues["b"].delete("default/w1")
    t = threading.Thread(
        target=lambda: woke.append(qm.wait_for_pending(timeout=10.0)))
    t.start()
    time.sleep(0.05)
    qm.wakeup()
    t.join(timeout=10.0)
    assert not t.is_alive() and woke == [True, False]


# -- chip_smoke.py phase 15 ---------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_copies_are_the_shared_ones(jax_runs):
    smoke = _chip_smoke()
    run = jax_runs["case", "capacity_event"]
    store = run.store
    assert smoke.timed_store_digest(store) == S.timed_store_digest(store)
    assert smoke._queue_state(run.queues) == S.queue_state(run.queues)
    assert smoke.STREAMING_RUNS == S.STREAMING_RUNS


def test_phase15_pins_agree_across_twins():
    """The micro-solve and host-walk pins are one record but for the
    micro-solve counts, and every stream twin's committed digests are
    its batch twin's."""
    ref = _chip_smoke().STREAMING_REFERENCE
    micro, host = ref["single"]["micro"], ref["single"]["host"]
    assert micro["boundaries"] == host["boundaries"]
    assert micro["micro_solves"] > 0 and host["micro_solves"] == 0
    for profile, stream in (("single", "micro"), ("wide", "stream")):
        assert (ref[profile][stream]["committed"]
                == ref[profile]["batch"]["committed"])
        per_tick, ticks, _ = S.STREAMING_RUNS[profile]
        assert len(ref[profile]["batch"]["boundaries"]) == ticks // 100
        assert ref[profile][stream]["workloads"] == per_tick * ticks


def test_phase15_runs_on_the_cpu(jax_runs):
    """chip_smoke.py's phase 15 on the CPU at the cut size, each twin
    held to the JAX package's record of the same cut."""
    smoke = _chip_smoke()
    runs = {p: (per_tick, 8, twins) for p, (per_tick, twins) in TICKS.items()}
    reference = {p: {t: jax_runs["ticks", p, t] for t in twins}
                 for p, (_, twins) in TICKS.items()}
    out, launches = smoke.streaming_fleets("cpu", runs=runs,
                                           reference=reference,
                                           solve_every=4)
    assert launches == 0
    assert out["single"]["micro_drains_compared"] == 8
    assert out["single"]["micro"]["micro_solves"] == 6
    serve = smoke.streaming_serve("cpu", bursts=2)
    assert serve["admitted"] == 2 * 128 + 8
    assert serve["worker_micro_solves"] >= 1
    assert len(serve["single_admit_s"]) == 8
