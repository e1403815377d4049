"""The port's perf harness (kueue_oss_tpu_torch/perf/) on the CPU against
the JAX package's: the generator builds equal stores and schedules, the
Simulator's SimStats and committed store (QuotaReserved times included)
are equal host-only and with ``solver="auto"`` (cost gates pinned, see
tests/torch_sim_pins.py), ``drain_benchmark`` solves the same plan, and
the checker reports the same violations."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import math

import pytest

from kueue_oss_tpu.perf import checker as jax_checker
from kueue_oss_tpu.perf import generator as jax_gen
from kueue_oss_tpu.perf import runner as jax_runner
from kueue_oss_tpu_torch.perf import checker as port_checker
from kueue_oss_tpu_torch.perf import generator as port_gen
from kueue_oss_tpu_torch.perf import runner as port_runner
from torch_sim_pins import (
    JAX,
    PORT,
    baseline_config,
    drain_bench_record,
    large_scale_config,
    sim_record,
)


def _store_view(store) -> dict:
    """Every object of a generated store as plain values."""
    def quotas(cq):
        return [[rg.covered_resources,
                 [[fq.name, [[r.name, r.nominal, r.borrowing_limit,
                              r.lending_limit] for r in fq.resources]]
                  for fq in rg.flavors]]
                for rg in cq.resource_groups]

    return {
        "flavors": sorted(store.resource_flavors),
        "cohorts": sorted(store.cohorts),
        "cqs": {name: [cq.cohort, cq.preemption.reclaim_within_cohort,
                       cq.preemption.within_cluster_queue, quotas(cq)]
                for name, cq in sorted(store.cluster_queues.items())},
        "lqs": {key: lq.cluster_queue
                for key, lq in sorted(store.local_queues.items())},
        "workloads": sorted(store.workloads),
    }


def _schedule_view(schedule) -> list:
    return [[g.class_name, g.runtime_ms, g.arrival_ms, g.workload.name,
             g.workload.queue_name, g.workload.priority,
             g.workload.creation_time,
             [[ps.name, ps.count, sorted(ps.requests.items())]
              for ps in g.workload.podsets]]
            for g in schedule]


@pytest.mark.parametrize("shape", ["baseline_2x3", "heterogeneous_2x3"])
def test_generate_matches_jax(shape):
    def config(gen):
        if shape == "baseline_2x3":
            return baseline_config(gen, n_cohorts=2, cqs_per_cohort=3)
        return gen.GeneratorConfig.heterogeneous(2, 3)

    jstore, jsched = jax_gen.generate(config(jax_gen))
    pstore, psched = port_gen.generate(config(port_gen))
    assert _store_view(pstore) == _store_view(jstore)
    assert _schedule_view(psched) == _schedule_view(jsched)
    assert len(psched) == (3000 if shape == "baseline_2x3" else 270)


def test_simulator_host_only_matches_jax():
    """The JAX test's shape (tests/test_perf_harness.py: 2 x 3
    ClusterQueues, 3,000 workloads) through host cycles only; the
    port's scheduler keeps its default ``device="cuda"`` and must not
    touch it."""
    jrec, _, _ = sim_record(JAX, jax_gen.GeneratorConfig(
        n_cohorts=2, cqs_per_cohort=3), solver=False)
    store, schedule = port_gen.generate(port_gen.GeneratorConfig(
        n_cohorts=2, cqs_per_cohort=3))
    sim = port_runner.Simulator(store, schedule)  # device="cuda" default
    assert sim.scheduler._solver_engine() is None
    stats = sim.run()
    from torch_streaming_pins import timed_store_digest

    prec = {"admitted": stats.admitted, "finished": stats.finished,
            "preemptions": stats.preemptions, "cycles": stats.cycles,
            "sim_wall_ms": stats.sim_wall_ms,
            "tta_ms_by_class": dict(sorted(stats.tta_ms_by_class.items())),
            "digest": timed_store_digest(store)}
    assert prec == jrec
    assert stats.admitted == stats.total_workloads == 3000
    assert stats.preemptions > 0
    assert port_checker.check(stats, port_checker.BASELINE_SPEC) == []


def test_simulator_auto_matches_jax():
    """``solver="auto"`` with the cost gates pinned and a drain
    threshold of 8, so that device drains happen at this size."""
    kw = dict(solver=True, min_backlog=8)
    jrec, _, _ = sim_record(JAX, baseline_config(jax_gen, 0.1, 2, 3), **kw)
    prec, _, sim = sim_record(PORT, baseline_config(port_gen, 0.1, 2, 3),
                              **kw)
    assert prec == jrec
    assert prec["drains"] > 1 and prec["unsupported"] == 0
    counts = sim.scheduler.solver_counts
    assert counts["drains"] == prec["drains"]
    assert counts["plan_fallbacks"] == counts["unavailable"] == 0
    assert sim.scheduler.last_drain.verified > 0


def test_drain_benchmark_matches_jax():
    """Kueue's large-scale shape cut to 2 x 5 ClusterQueues."""
    def cfg(gen):
        return large_scale_config(gen, n_cohorts=2, cqs_per_cohort=5)

    jrec, _ = drain_bench_record(JAX, cfg(jax_gen))
    prec, out = drain_bench_record(PORT, cfg(port_gen))
    assert prec == jrec
    assert prec["admitted"] > 0 and prec["cluster_queues"] == 10
    assert out["solve_seconds"] > 0
    assert math.isclose(out["cycle_ms"], out["solve_seconds"] * 1000.0
                        / prec["rounds"])


def test_device_entry_points_raise_without_cuda():
    store, schedule = port_gen.generate(baseline_config(port_gen, 0.02,
                                                        1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_runner.Simulator(store, schedule, solver="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_runner.drain_benchmark(store, schedule)


def test_timed_hooks_fire_at_their_virtual_time():
    def run(gen, runner):
        fired = []
        store, schedule = gen.generate(baseline_config(gen, 0.02, 1, 2))
        sim = runner.Simulator(store, schedule, timed_hooks=[
            (1500.0, lambda s, now: fired.append(
                (now, sum(w.is_quota_reserved
                          for w in s.store.workloads.values()))))])
        stats = sim.run()
        return fired, stats.cycles, stats.admitted

    assert run(port_gen, port_runner) == run(jax_gen, jax_runner)


class TestChecker:
    """The cases of tests/test_perf_harness.py's TestChecker, on both
    packages' checkers."""

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_passing_run_has_no_violations(self, pkg):
        chk, runner = ((jax_checker, jax_runner) if pkg == "jax"
                       else (port_checker, port_runner))
        stats = runner.SimStats(
            total_workloads=100, admitted=100, finished=100,
            sim_wall_ms=1000.0, tta_ms_by_class={"large": 50.0},
            admissions_per_real_second=500.0)
        spec = chk.RangeSpec(max_wall_ms=2000.0,
                             max_tta_ms_by_class={"large": 100.0},
                             min_admissions_per_second=100.0)
        assert chk.check(stats, spec) == []

    def test_violations_reported_individually(self):
        def violations(chk, runner):
            stats = runner.SimStats(
                total_workloads=100, admitted=90, sim_wall_ms=5000.0,
                tta_ms_by_class={"large": 500.0},
                admissions_per_real_second=10.0)
            spec = chk.RangeSpec(
                max_wall_ms=2000.0,
                max_tta_ms_by_class={"large": 100.0, "medium": 100.0},
                min_admissions_per_second=100.0)
            return chk.check(stats, spec)

        got = violations(port_checker, port_runner)
        assert len(got) == 5, got
        assert got == violations(jax_checker, jax_runner)

    def test_baseline_spec_is_the_jax_one(self):
        assert (vars(port_checker.BASELINE_SPEC)
                == vars(jax_checker.BASELINE_SPEC))

    def test_summary_matches_jax(self):
        kw = dict(total_workloads=10, admitted=9, finished=8,
                  sim_wall_ms=1234.0, real_seconds=0.5, cycles=7,
                  tta_ms_by_class={"small": 12.0, "large": 3.0},
                  admissions_per_real_second=18.0)
        assert (port_runner.SimStats(**kw).summary()
                == jax_runner.SimStats(**kw).summary())
