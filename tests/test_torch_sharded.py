"""The port's mesh drains against the JAX package's, on the CPU.

The JAX package runs its ``shard_map`` drains on the conftest's 8
virtual CPU devices; the port runs its mesh on the CPU repeated by
``meshutil.set_virtual_devices(8)`` (reset after every test: xdist runs
several files in one process). Tolerance 0 throughout but for the
relaxed LP's x, which is compared bit for bit (XLA:CPU's all-reduce adds
the shards in order, as ``meshutil.psum`` does).

- the lean mesh drain (``solve_backlog_sharded``) on the whole tuple at
  widths 2, 3, 5 and 8 (uneven W+1) against JAX's live, and on the
  64-ClusterQueue store against its pin (tests/torch_mesh_pins.py);
- the FULL and fair mesh drains (``solve_backlog_full_sharded``) on all
  8 outputs against the pins, two pins against JAX's live drain, and
  against the port's single-device drain, with the bytes the lane split
  replicates to the other shards;
- the mesh-sharded relaxed LP against JAX's mesh LP (x and plan) and
  the single-device plan; the scenario mesh against the unsharded
  sweep; the collectives' shard order and the placement's isolation.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_pins as pins
from kueue_oss_tpu.core.queue_manager import QueueManager
from kueue_oss_tpu.solver.engine import SolverEngine
from kueue_oss_tpu_torch.convert import problem_from_arrays
from kueue_oss_tpu_torch.solver import meshutil, sharded
from test_solver_parity import Cohort, build_store, make_cq, submit


@pytest.fixture(autouse=True)
def virtual_mesh():
    meshutil.set_virtual_devices(8)
    yield
    meshutil.set_virtual_devices(0)


def _export(store):
    engine = SolverEngine(store, QueueManager(store), mesh_mode="off")
    problem, _ = engine.export()
    return problem


def _flavor_store():
    """tests/test_sharded.py::test_flavors_and_limits's store."""
    store = build_store(
        [make_cq("a", 0, "co", flavors=[("od", 2000), ("spot", 4000)],
                 borrowing_limit=1000),
         make_cq("b", 0, "co", flavors=[("od", 1000), ("spot", 0)],
                 lending_limit=500)],
        [Cohort(name="co")], flavors=("od", "spot"))
    for i in range(8):
        submit(store, f"w{i}", "ab"[i % 2], t=float(i),
               cpu=[500, 1500, 3000][i % 3], priority=i % 2)
    return store


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


# ---------------------------------------------------------------------------
# meshutil
# ---------------------------------------------------------------------------


def test_mesh_detection_follows_the_jax_grammar():
    from kueue_oss_tpu.solver import meshutil as jmu

    for mode in ("auto", "on", "", "off", "none", "0", "1", "2", "8",
                 "bogus", None):
        assert meshutil.parse_mesh_mode(mode) == jmu.parse_mesh_mode(mode)
    assert meshutil.mesh_devices(meshutil.detect_mesh("auto",
                                                      device="cpu")) == 8
    assert meshutil.detect_mesh("16", device="cpu") is None  # fail closed
    assert meshutil.detect_mesh("off", device="cpu") is None
    assert meshutil.mesh_devices(meshutil.detect_mesh(
        "8", max_devices=3, device="cpu")) == 3
    meshutil.set_virtual_devices(0)
    # the CPU is one device: no mesh, as JAX without its flag
    assert meshutil.detect_mesh("auto", device="cpu") is None
    for target, w, extra in ((64, 8, 0), (63, 8, 0), (64, 3, 0),
                             (100, 0, 5), (64, 4, 6), (64, 0, 0)):
        jmesh = pins.jax_mesh(w) if w > 1 else None
        assert (meshutil.align_pad_target(target, w, extra)
                == jmu.align_pad_target(target, jmesh, extra))


def test_collectives_reduce_in_shard_order():
    """psum adds the shards' parts in shard order on each device, as
    XLA:CPU's all-reduce: float sums depend on it."""
    mesh = meshutil.detect_mesh("3", device="cpu")
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([-1e8], dtype=torch.float32),
             torch.tensor([1.0], dtype=torch.float32)]
    assert [float(p) for p in meshutil.psum(mesh, parts)] == [1.0] * 3
    assert float(meshutil.psum(mesh, parts[::-1])[0]) == 0.0
    got = meshutil.pmin(mesh, [torch.tensor([3, 1]), torch.tensor([2, 5]),
                              torch.tensor([4, 0])])
    assert all(g.tolist() == [2, 0] for g in got)
    joined = meshutil.all_gather(mesh, [torch.arange(2) + 2 * s
                                        for s in range(3)])
    assert joined[0].tolist() == [0, 1, 2, 3, 4, 5]


def test_placement_holds_only_each_shards_block():
    """Each shard's resident row tensors hold only its W1 / n rows, each
    a tensor of its own; the replicated state is a copy per shard."""
    from kueue_oss_tpu_torch.solver.kernels import host_tensors

    problem = sharded.pad_workloads(
        problem_from_arrays(_export(_flavor_store())), 3)
    mesh = meshutil.detect_mesh("3", device="cpu")
    mt = sharded.place_lean_tensors(host_tensors(problem), mesh)
    W1 = problem.wl_cqid.shape[0]
    assert mt.block * 3 == W1 and mt.rows == W1
    for s, shard in enumerate(mt.shards):
        for f in sharded.LEAN_WL_FIELDS:
            block = getattr(shard, f)
            assert block.shape[0] == W1 // 3
            assert np.array_equal(
                block.numpy(),
                np.asarray(getattr(problem, f))[s * mt.block:
                                                (s + 1) * mt.block])
    a, b = mt.shards[0].wl_req, mt.shards[1].wl_req
    assert a.data_ptr() != b.data_ptr()
    assert (mt.shards[0].nominal.data_ptr()
            != mt.shards[1].nominal.data_ptr())
    with pytest.raises(ValueError, match="does not shard"):
        sharded.place_lean_tensors(
            host_tensors(problem_from_arrays(_export(_flavor_store()))),
            meshutil.detect_mesh("4", device="cpu"))


# ---------------------------------------------------------------------------
# the lean mesh drain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 3, 5, 8])
def test_lean_mesh_drain_equals_jax(width):
    from kueue_oss_tpu.solver.sharded import solve_backlog_sharded as jsbs

    problem = _export(_flavor_store())
    want = jsbs(problem, pins.jax_mesh(width))
    got = sharded.solve_backlog_sharded(problem_from_arrays(problem),
                                        pins.port_mesh(width))
    assert len(got) == 6
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_lean_mesh_drain_equals_the_pin_and_the_single_drain():
    """64 ClusterQueues over 8 shards: every head surfaces through the
    cross-shard pmins; equal to JAX's pinned plan and to the port's
    single-device drain of the same padded problem."""
    from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device

    assert pins.lean_record(pins.PORT) == pins.PINS["lean"]
    problem = sharded.pad_workloads(problem_from_arrays(pins.lean_problem()),
                                    8)
    single = solve_backlog(to_device(problem, "cpu"))
    mesh_out = sharded.solve_backlog_sharded(problem, pins.port_mesh(8))
    for a, b in zip(single, mesh_out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the FULL and fair mesh drains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(pins.FULL_CASES))
def test_full_mesh_drain_equals_the_jax_pin(case):
    assert pins.full_record(pins.PORT, case) == pins.PINS["full"][case]


@pytest.mark.parametrize("case", ["uneven_w5", "fair_s2_w8"])
def test_full_mesh_pin_is_the_live_jax_drain(case):
    """The pins stay tied to the JAX package: its FULL mesh drain, run
    live on the conftest's devices (the uneven 5-wide classical case and
    a fair-sharing case), gives the pinned record."""
    assert pins.full_record(pins.JAX, case) == pins.PINS["full"][case]


@pytest.mark.parametrize("case", ["classical_s0_w8", "fair_s2_w8",
                                  "uneven_w5"])
def test_full_mesh_drain_equals_the_single_drain(case):
    """The lane split and the row gather change no bit of the FULL
    drain's 8 outputs against the port's single-device drain."""
    from kueue_oss_tpu_torch.solver.fair_kernels import (
        lendable_by_resource,
    )
    from kueue_oss_tpu_torch.solver.full_kernels import (
        FullDrainStats,
        potential_available_all,
        solve_backlog_full,
        to_device_full,
    )
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads as pad_rows

    kind, seed, width = pins.FULL_CASES[case]
    problem = problem_from_arrays(pins.full_problem(kind, seed))
    kw = dict(g_max=int(problem.cq_ngroups.max()), h_max=8, p_max=32,
              fs_enabled=kind == "fair")
    single = solve_backlog_full(to_device_full(problem, "cpu"), **kw)
    stats = FullDrainStats()
    got = sharded.solve_backlog_full_sharded(problem, pins.port_mesh(width),
                                             stats=stats, **kw)
    for a, b in zip(single, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert stats.lanes > 0
    # t and lendable_r reach the other shards once a drain, the round
    # state once a round; nothing else is replicated
    W1 = problem.wl_cqid.shape[0]
    t = to_device_full(pad_rows(problem, W1 - 1 + (-W1) % width), "cpu")
    drain = [*t] + ([lendable_by_resource(t, potential_available_all(t))]
                    if kind == "fair" else [])
    per_round = [t.usage0, t.ad_usage, t.wl_admitted0, t.wl_evicted0,
                 t.wl_ts0]
    assert stats.replicated_bytes == (width - 1) * (
        _nbytes(drain) + stats.rounds * _nbytes(per_round))


# ---------------------------------------------------------------------------
# the relaxed LP on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [4, 8])
def test_mesh_relaxed_lp_equals_jax(width):
    """tests/test_relax.py:367-390's store: the mesh LP's x equals JAX's
    mesh x bit for bit (the shards' loads added in shard order), and its
    plan equals JAX's mesh plan and the single-device plan."""
    from kueue_oss_tpu.solver import meshutil as jmu
    from kueue_oss_tpu.solver import relax as jrelax
    from kueue_oss_tpu.solver.tensors import pad_workloads, pow2
    from kueue_oss_tpu_torch.solver import relax as prelax
    from test_relax import _add, _store

    store = _store(n_cqs=4, quota=8)
    for i in range(60):
        _add(store, i, prio=i % 2)
    problem = _export(store)
    jm = jmu.detect_mesh(str(width))
    problem = pad_workloads(problem, jmu.align_pad_target(
        pow2(problem.n_workloads), jm))
    want, wstats = jrelax.solve_relaxed(problem, mesh=jm)
    pp = problem_from_arrays(problem)
    got, gstats = prelax.solve_relaxed(pp, mesh=pins.port_mesh(width),
                                       device="cpu")
    single, sstats = prelax.solve_relaxed(pp, device="cpu")
    assert np.array_equal(gstats.x, wstats.x)
    assert not np.array_equal(gstats.x, sstats.x)  # another float order
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert prelax.plans_agree(got, single, problem.n_workloads)


def test_mesh_relaxed_lp_falls_back_when_the_axis_does_not_shard():
    from kueue_oss_tpu_torch.solver import relax as prelax
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads

    pp = pad_workloads(problem_from_arrays(_export(_flavor_store())), 9)
    assert pp.wl_cqid.shape[0] % 3 != 0
    _, got = prelax.solve_relaxed(pp, mesh=pins.port_mesh(3), device="cpu")
    _, single = prelax.solve_relaxed(pp, device="cpu")
    assert np.array_equal(got.x, single.x)


def test_shard_entries_plain_versions_step_like_the_single_lp():
    """On one shard the two entries' plain versions are the single
    device's step: lp_step_from_load(lp_load(x)) is lp_step_body."""
    from kueue_oss_tpu_torch.solver import cuda_relax, relax as prelax
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads

    pp = pad_workloads(problem_from_arrays(_export(_flavor_store())), 15)
    lp = prelax.lp_to_device(prelax.build_lp(pp), "cpu")
    x = torch.where(lp.live, 0.5, 0.0).to(torch.float32)
    for i in range(4):
        load = cuda_relax.relax_lp_shard_load(lp, x)
        nxt = cuda_relax.relax_lp_shard_step(lp, x, load, i, 4)
        assert torch.equal(nxt, prelax.lp_step_body(lp, x, i, 4))
        x = nxt


# ---------------------------------------------------------------------------
# the scenario mesh
# ---------------------------------------------------------------------------


def test_scenario_mesh_equals_the_unsharded_sweep():
    """sim/batch.py's scenario mesh: 16 worlds block-sharded over 8 (and
    4) shards give the unsharded batch's plans bit for bit; 12 worlds
    padded to 16 shard too, 3 worlds over 8 shards do not."""
    from kueue_oss_tpu_torch.sim import batch
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads

    problem = pad_workloads(problem_from_arrays(_export(_flavor_store())),
                            15)
    base = np.asarray(problem.nominal)
    overlays = [{"nominal": (base * (1 + (i % 5)) // 2).astype(np.int32)}
                for i in range(16)]
    plain = batch.solve_scenarios(problem, overlays, device="cpu")
    for width in (8, 4):
        got = batch.solve_scenarios(problem, overlays,
                                    mesh=pins.port_mesh(width), device="cpu")
        assert got.mesh_devices == width
        for name in ("admitted", "opt", "admit_round", "parked", "rounds",
                     "usage"):
            assert np.array_equal(getattr(got, name), getattr(plain, name))
    assert batch.solve_scenarios(problem, overlays[:12],
                                 mesh=pins.port_mesh(8),
                                 device="cpu").mesh_devices == 8
    assert batch.solve_scenarios(problem, overlays[:3],
                                 mesh=pins.port_mesh(8), pad_pow2=False,
                                 device="cpu").mesh_devices == 0
    res, _stats, _n = batch.solve_scenarios_bucketed(
        problem, overlays, mesh=pins.port_mesh(8), device="cpu")
    assert np.array_equal(res.admitted, plain.admitted)


def test_whatif_engine_reports_the_scenario_mesh():
    """WhatIfEngine: SimulatorConfig.mesh with min_batch_for_mesh; the
    report's digest is the unsharded run's, its timing the width."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.config.configuration import SimulatorConfig
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.sim import ScenarioSpec, WhatIfEngine

    def store():
        st = Store()
        st.upsert_resource_flavor(T.ResourceFlavor(name="f"))
        st.upsert_cohort(T.Cohort(name="co"))
        for i in range(3):
            st.upsert_cluster_queue(T.ClusterQueue(
                name=f"cq{i}", cohort="co",
                resource_groups=[T.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[T.FlavorQuotas(name="f", resources=[
                        T.ResourceQuota(name="cpu", nominal=6)])])]))
            st.upsert_local_queue(T.LocalQueue(name=f"lq{i}",
                                               cluster_queue=f"cq{i}"))
        for i in range(30):
            st.add_workload(T.Workload(
                name=f"w{i}", queue_name=f"lq{i % 3}", uid=i + 1,
                creation_time=float(i),
                podsets=[T.PodSet(name="main", count=1,
                                  requests={"cpu": 1 + i % 2})]))
        return st

    specs = [ScenarioSpec(f"s{i}", quota_scale={"cohort-x": 1.0},
                          arrival_scale=1.0 + 0.1 * (i % 4))
             for i in range(16)]
    cfgs = [SimulatorConfig(mesh="8", min_batch_for_mesh=16,
                            round_bucketing=False),
            SimulatorConfig(round_bucketing=False)]
    reports = [WhatIfEngine(store(), config=c, device="cpu").run(
        specs, parity=1) for c in cfgs]
    assert reports[0].timing["mesh_devices"] == 8
    assert reports[1].timing["mesh_devices"] == 0
    assert (reports[0].canonical_json() == reports[1].canonical_json())
    small = dataclasses.replace(cfgs[0], min_batch_for_mesh=32)
    assert WhatIfEngine(store(), config=small, device="cpu").run(
        specs, parity=0).timing["mesh_devices"] == 0
