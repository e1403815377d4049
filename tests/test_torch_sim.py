"""The port's lean what-if sweep (kueue_oss_tpu_torch/sim/ and
``solver.kernels.solve_backlog_batched``) on the CPU against the JAX
package's: the batched drain equals the JAX ``vmap`` batch field for
field on seeded quota, arrival (replicas 2 and 3), priority-shift and
churn sweeps, on an all-fields batch and with padded scenarios, and
equals the port's own drain run scenario by scenario; the scenario
layer's overlays, the engine's report (``canonical_json``, bucketing on
and off), ``pending_backlog`` and ``simulate_trace`` equal the JAX
package's. Problems and overlays cross as numpy arrays
(``convert.problem_from_arrays``), specs as ``to_dict`` /
``from_dict``."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import math

import numpy as np
import pytest

from kueue_oss_tpu.config.configuration import (
    SimulatorConfig as JaxSimConfig,
)
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.perf import generator as jax_gen
from kueue_oss_tpu import sim as jax_sim
from kueue_oss_tpu.sim import batch as jax_batch
from kueue_oss_tpu.sim.engine import (
    _materialize_replicas as jax_replicas,
)
from kueue_oss_tpu.solver import kernels as jax_kernels
from kueue_oss_tpu.solver import tensors as jax_tensors
from kueue_oss_tpu_torch import convert
from kueue_oss_tpu_torch import sim as port_sim
from kueue_oss_tpu_torch.config import SimulatorConfig
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.perf import generator as port_gen
from kueue_oss_tpu_torch.sim import batch as port_batch
from kueue_oss_tpu_torch.sim import scenario as port_scenario
from kueue_oss_tpu_torch.solver import kernels as port_kernels

OUTPUTS = ("admitted", "opt", "admit_round", "parked", "rounds", "usage")


def _contended_store(gen, n_cohorts=2, cqs=3, counts=(6, 2, 1)):
    """tests/test_sim_whatif.py's store: large_scale(preemption=False)
    cut to ``n_cohorts`` x ``cqs`` ClusterQueues, the backlog pending."""
    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs
    for wc, n in zip(cfg.classes, counts):
        wc.count = n
    store, schedule = gen.generate(cfg)
    for g in schedule:
        store.add_workload(g.workload)
    return store, schedule


def _grid(sim, n):
    specs = sim.cross(sim.quota_sweep((0.25, 0.5, 1.5, 2.0, 3.0)),
                      sim.arrival_sweep((0.5, 0.75, 1.5, 2.0, 2.5)))
    if len(specs) < n:
        specs = specs * (n // len(specs) + 1)
    return specs[:n]


def _jax_problem(replicas=1):
    """The JAX export of the contended backlog (clones materialized for
    ``replicas`` > 1), padded to a power of two."""
    store, _ = _contended_store(jax_gen)
    pending = jax_replicas(jax_sim.pending_backlog(store), replicas)
    problem = jax_tensors.export_problem(
        store, pending,
        cache=jax_tensors.ExportCache(store, subscribe=False))
    return jax_tensors.pad_workloads(
        problem, jax_tensors.pow2(problem.n_workloads))


def _sweep(name):
    """(JAX specs, replicas) of one seeded sweep."""
    S = jax_sim.ScenarioSpec
    if name == "quota":
        return jax_sim.quota_sweep((0.25, 0.5, 0.75, 1.5, 2.0, 3.0),
                                   target="cohort-0") + [
            S("cq", quota_scale={"cq-1-*": 0.0})], 1
    if name == "arrival_x2":
        return jax_sim.arrival_sweep((0.25, 0.5, 1.5, 2.0)), 2
    if name == "arrival_x3":
        return jax_sim.cross(jax_sim.quota_sweep((0.5, 2.0)),
                             jax_sim.arrival_sweep((0.4, 2.5, 3.0))), 3
    if name == "priority_shift":
        return [S("base"), S("up", priority_shift={"cq-0-*": 100}),
                S("down", priority_shift={"cq-1-1": -300, "cq-0-2": 7})], 1
    if name == "churn":
        return [S(f"churn{s}", priority_churn_fraction=f,
                  priority_churn_delta=d, seed=s)
                for s, (f, d) in enumerate(((0.5, 200), (0.25, -100),
                                            (1.0, 60), (0.1, 500)))], 1
    raise KeyError(name)


def _port_overlays(specs, port_problem, replicas):
    """The port's own overlays of the JAX specs (crossed as dicts)."""
    arrival_idx = port_scenario.arrival_order(port_problem)
    return [port_sim.ScenarioSpec.from_dict(s.to_dict()).overlay(
        port_problem, replicas=replicas, arrival_idx=arrival_idx)
        for s in specs]


def _assert_overlays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _assert_plans_equal(got, want, label=""):
    for g, w, name in zip(got, want, OUTPUTS):
        g = g.numpy() if hasattr(g, "numpy") else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (label, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("sweep", ["quota", "arrival_x2", "arrival_x3",
                                   "priority_shift", "churn"])
def test_batched_drain_matches_jax_vmap(sweep):
    specs, replicas = _sweep(sweep)
    jp = _jax_problem(replicas)
    overlays = [s.overlay(jp, replicas=replicas) for s in specs]
    pp = convert.problem_from_arrays(jp)
    _assert_overlays_equal(_port_overlays(specs, pp, replicas), overlays)

    stacked = jax_batch.pad_scenario_axis(
        jax_batch.stack_overlays(jp, overlays), 8)
    want = jax_kernels.solve_backlog_batched(jax_kernels.to_device(jp),
                                             stacked)
    counts = {}
    got = port_kernels.solve_backlog_batched(
        port_kernels.to_device(pp, "cpu"), stacked, counts)
    _assert_plans_equal(got, want, sweep)
    rounds = np.asarray(want[4])
    assert counts["host_reads"] == rounds.max()
    worlds = {np.asarray(want[0])[i].tobytes()
              + np.asarray(want[2])[i].tobytes() for i in range(len(specs))}
    assert len(worlds) > 1, "vacuous: every scenario drains alike"

    # and the port's drain run scenario by scenario
    seq = port_batch.solve_scenarios_sequential(pp, overlays,
                                                device="cpu")
    for i in range(len(specs)):
        _assert_plans_equal([g[i] for g in got], seq.plan(i),
                            f"{sweep}[{i}]")


def test_all_fields_batch_matches_jax_vmap():
    """Every ProblemTensors field carries the scenario axis (the JAX
    dispatcher's whole-problem batches)."""
    specs, replicas = _sweep("arrival_x3")
    jp = _jax_problem(replicas)
    overlays = [s.overlay(jp, replicas=replicas) for s in specs[:3]]
    host = jax_kernels.host_tensors(jp)
    stacked = {name: np.stack([np.asarray(ov.get(name, getattr(host, name)))
                               for ov in overlays])
               for name in jax_kernels.ALL_PROBLEM_FIELDS}
    want = jax_kernels.solve_backlog_batched(jax_kernels.to_device(jp),
                                             stacked)
    pp = convert.problem_from_arrays(jp)
    got = port_kernels.solve_backlog_batched(
        port_kernels.to_device(pp, "cpu"), stacked)
    _assert_plans_equal(got, want, "all fields")
    narrow = port_batch.solve_scenarios(pp, overlays, pad_pow2=False,
                                        device="cpu")
    for i in range(3):
        _assert_plans_equal([g[i] for g in got], narrow.plan(i), str(i))


def test_padded_scenarios_are_inert():
    specs, _ = _sweep("churn")
    specs = specs[:3] + [jax_sim.ScenarioSpec("q", quota_scale={"*": 0.5})]
    jp = _jax_problem()
    pp = convert.problem_from_arrays(jp)
    overlays = [s.overlay(jp) for s in specs]
    padded = port_batch.solve_scenarios(pp, overlays, device="cpu")
    exact = port_batch.solve_scenarios(pp, overlays, pad_pow2=False,
                                       device="cpu")
    assert padded.batch_width == 4 and exact.batch_width == 4
    overlays5 = overlays + [overlays[1]]
    padded = port_batch.solve_scenarios(pp, overlays5, device="cpu")
    assert padded.batch_width == 8 and padded.admitted.shape[0] == 5
    want = jax_batch.solve_scenarios(jp, overlays5)
    for name in OUTPUTS:
        np.testing.assert_array_equal(getattr(padded, name),
                                      getattr(want, name), err_msg=name)
    for i in range(4):
        _assert_plans_equal(padded.plan(i), exact.plan(i), str(i))
    # the three padding lanes are repeats of scenario 0
    stacked = port_batch.pad_scenario_axis(
        port_batch.stack_overlays(pp, overlays5), 8)
    full = port_kernels.solve_backlog_batched(
        port_kernels.to_device(pp, "cpu"), stacked)
    for lane in (5, 6, 7):
        _assert_plans_equal([g[lane] for g in full],
                            [g[0] for g in full], f"pad {lane}")


def test_batched_drain_errors_match_jax():
    jp = _jax_problem()
    pp = convert.problem_from_arrays(jp)
    t = port_kernels.to_device(pp, "cpu")
    for overrides, match in (({}, "at least one"),
                             ({"bogus": np.zeros((2, 3))},
                              "not ProblemTensors fields")):
        with pytest.raises(ValueError, match=match):
            jax_kernels.solve_backlog_batched(jax_kernels.to_device(jp),
                                              overrides)
        with pytest.raises(ValueError, match=match):
            port_kernels.solve_backlog_batched(t, overrides)
    assert port_kernels.BATCHABLE_FIELDS == jax_kernels.BATCHABLE_FIELDS
    assert (port_kernels.ALL_PROBLEM_FIELDS
            == jax_kernels.ALL_PROBLEM_FIELDS)
    with pytest.raises(ValueError, match="at least one"):
        port_batch.solve_scenarios(pp, [], device="cpu")


@pytest.mark.parametrize("bucketing", [True, False])
def test_whatif_report_byte_identical_to_jax(bucketing):
    jstore, _ = _contended_store(jax_gen)
    pstore, _ = _contended_store(port_gen)
    want = jax_sim.WhatIfEngine(
        jstore, config=JaxSimConfig(round_bucketing=bucketing)).run(
        _grid(jax_sim, 64), parity=4)
    got = port_sim.WhatIfEngine(
        pstore, config=SimulatorConfig(round_bucketing=bucketing),
        device="cpu").run(_grid(port_sim, 64), parity=4)
    assert got.canonical_json() == want.canonical_json()
    assert got.parity == {"checked": 4, "identical": True,
                          "mismatches": []}
    for key in ("batch_width", "batch_dispatches", "round_buckets"):
        assert got.timing[key] == want.timing[key], key
    assert (got.timing["batch_dispatches"] > 1) == bucketing
    assert got.timing["host_reads"] > 0
    assert len({s["admitted"] for s in got.scenarios}) > 2


def test_scenario_spec_validate_and_round_trip():
    spec = jax_sim.ScenarioSpec(
        "x", quota_scale={"cohort-*": 0.5}, arrival_scale=1.5,
        priority_shift={"cq-0-1": 3}, priority_churn_fraction=0.25,
        priority_churn_delta=9, seed=7,
        node_flaps=[jax_sim.FlapEvent(at_ms=5.0, count=2)])
    port = port_sim.ScenarioSpec.from_dict(spec.to_dict())
    assert port.to_dict() == spec.to_dict()
    assert port_sim.ScenarioSpec.from_dict(port.to_dict()) == port
    port.validate()
    bad = [dict(quota_scale={"a": float("nan")}),
           dict(quota_scale={"a": -1.0}),
           dict(arrival_scale=math.inf), dict(arrival_scale=-0.5),
           dict(priority_churn_fraction=1.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            jax_sim.ScenarioSpec("b", **kw).validate()
        with pytest.raises(ValueError):
            port_sim.ScenarioSpec("b", **kw).validate()
    a = jax_sim.cross(jax_sim.quota_sweep((0.5, 2.0), seed=3),
                      jax_sim.arrival_sweep((0.5,), seed=5))
    b = port_sim.cross(port_sim.quota_sweep((0.5, 2.0), seed=3),
                       port_sim.arrival_sweep((0.5,), seed=5))
    assert [s.to_dict() for s in b] == [s.to_dict() for s in a]


@pytest.mark.parametrize("with_queues", [False, True])
def test_pending_backlog_matches_jax(with_queues):
    jstore, _ = _contended_store(jax_gen)
    pstore, _ = _contended_store(port_gen)
    # park one ClusterQueue's backlog, admit nothing: both paths merge
    # heap and parked entries
    jq = JaxQueues(jstore) if with_queues else None
    pq = PortQueues(pstore) if with_queues else None
    want = jax_sim.pending_backlog(jstore, jq)
    got = port_sim.pending_backlog(pstore, pq)
    assert ({k: [i.obj.name for i in v] for k, v in got.items()}
            == {k: [i.obj.name for i in v] for k, v in want.items()})
    assert sum(len(v) for v in got.values()) == 54


def test_simulate_trace_matches_jax_and_refuses_flaps():
    def run(gen, sim, spec_cls, **kw):
        store, schedule = gen.generate(gen.GeneratorConfig(
            n_cohorts=1, cqs_per_cohort=2, classes=[
                gen.WorkloadClass("small", 12, 1, 50, 200, 100),
                gen.WorkloadClass("large", 4, 20, 200, 1000, 400)]))
        spec = spec_cls.from_dict(dict(
            name="t", arrival_scale=2.0, priority_shift={"cq-0-1": 100},
            priority_churn_fraction=0.5, priority_churn_delta=-60,
            seed=3))
        return sim.simulate_trace(store, schedule, spec, **kw)

    want = run(jax_gen, jax_sim, jax_sim.ScenarioSpec)
    got = run(port_gen, port_sim, port_sim.ScenarioSpec)
    assert got == want
    assert got["admitted"] == 32 and got["preemptions"] > 0

    # node flaps run now (they were refused before the TAS controllers
    # were ported): tests/test_sim_whatif.py's trace-mode schedule
    def flappy(gen, sim, types):
        cfg = gen.GeneratorConfig.large_scale(preemption=False)
        cfg.n_cohorts, cfg.cqs_per_cohort = 1, 2
        for wc, n in zip(cfg.classes, (4, 0, 0)):
            wc.count = n
        store, schedule = gen.generate(cfg)
        for i in range(4):
            store.upsert_node(types.Node(name=f"node-{i}"))
        spec = sim.ScenarioSpec(
            name="flappy", arrival_scale=2.0, seed=3,
            node_flaps=[sim.FlapEvent(at_ms=50.0, down=True, count=2),
                        sim.FlapEvent(at_ms=200.0, down=False)])
        return sim.simulate_trace(store, schedule, spec, **(
            {"device": "cpu"} if sim is port_sim else {}))

    from kueue_oss_tpu.api import types as jax_types
    from kueue_oss_tpu_torch.api import types as port_types

    want = flappy(jax_gen, jax_sim, jax_types)
    got = flappy(port_gen, port_sim, port_types)
    assert got == want
    assert len(got["node_flaps"]) == 2 and got["admitted"] > 0
    assert len(got["node_flaps"][0]["nodes"]) == 2
    assert got["node_flaps"][1] == {"atMs": 200.0, "down": False,
                                    "nodes": got["node_flaps"][0]["nodes"]}


def test_cut_paths_raise():
    store, _ = _contended_store(port_gen, 1, 1, (1, 0, 0))
    # the scenario mesh loads (item 9a); tests/test_torch_sharded.py
    # holds it against the unsharded sweep
    assert SimulatorConfig(mesh="auto").mesh == "auto"
    # the FULL sweep and the resident state run (ROADMAP Queue A item
    # 7b); tests/test_torch_fullsweep.py holds them against the JAX
    # package
    assert SimulatorConfig(full_kernel=True).full_kernel
    assert port_sim.WhatIfEngine(store, resident=True,
                                 device="cpu").resident is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sim.WhatIfEngine(store, resident=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sim.WhatIfEngine(store)
    stacked = {"usage0": np.zeros((4, 2, 1), dtype=np.int32)}
    assert port_batch._maybe_shard_scenarios(stacked, None) == (
        [(None, stacked)], 0)


def test_chip_smoke_copies_match_the_pins_helpers():
    """chip_smoke.py keeps its own copies of the pins script's plan
    digest, cost-gate pin, large-scale config and bench whatif
    problem."""
    import chip_smoke
    import torch_sim_pins as pins

    assert chip_smoke.PERF_AUTO_SCALE == pins.PERF_AUTO_SCALE
    for name in ("WHATIF_QUOTA", "WHATIF_ARRIVAL", "WHATIF_PARITY",
                 "BENCH_QUOTA", "BENCH_ARRIVAL"):
        assert getattr(chip_smoke, name) == getattr(pins, name), name
    problem, overlays = chip_smoke.bench_whatif_problem()
    want_problem, want_overlays = pins.bench_whatif_problem(pins.PORT)
    assert problem.wl_keys == want_problem.wl_keys
    _assert_overlays_equal(overlays, want_overlays)
    for kw in ({}, dict(per_cq=(14, 4, 2), n_cohorts=2, cqs_per_cohort=4)):
        got = chip_smoke._large_scale(port_gen, **kw)
        want = pins.large_scale_config(port_gen, **kw)
        assert repr(got) == repr(want)
    arrays = [problem.wl_req, problem.wl_valid, np.int32(7)]
    assert chip_smoke.plan_digest(arrays) == pins.plan_digest(arrays)

    class Sched:
        _drain_cost_ema = _host_s_per_adm = 1.0

        def _solver_drain(self, now):
            return (self._drain_cost_ema, self._host_s_per_adm, now)

    for pin in (chip_smoke.pin_cost_gates, pins.pin_cost_gates):
        sched = Sched()
        pin(sched)
        assert sched._solver_drain(5.0) == (None, None, 5.0)
