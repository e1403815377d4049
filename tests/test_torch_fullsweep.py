"""The port's FULL what-if sweeps (``kueue_oss_tpu_torch/sim/batch.py``
FULL section, ``sim/resident.py``, ``sim/traces.py``, the engine's FULL
path and ``full_kernels.solve_backlog_full_batched``) against the JAX
package on the CPU, on the same seeded stores.

Tolerance 0 throughout. Every case of tests/test_fullsweep.py is held
against the JAX package's own function: the chunked sweep at widths
1/2/4/8 on S = 9 (uneven tails) against the JAX sequential FULL
oracle, randomized lane budgets with the skew-aware order, the plan
math, the relax re-tier of a scenario above the budget and of a sweep
above the cap, the resident session's lifecycle (full -> reuse ->
scatter -> full), the engine's report (canonical JSON, tiers, KPIs, the
re-tier trail) and the traces (determinism, round trip, validation,
contention, the ladder). Added: ``host_tensors_full`` field by field,
a store with two resource groups (g_max = 2, the re-run of the victim
search on the combined request) and an admission-fair-sharing store.

One module-scoped JAX run serves the parity cases: the sequential
oracle (one compiled single-problem program) and the batched sweep of
the first 8 worlds at width 4 (one program). The engine cases share
the JAX engine's programs: one store shape, batches of 4 worlds.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest
import torch

from kueue_oss_tpu.config.configuration import (
    SimulatorConfig as JaxSimulatorConfig,
)
from kueue_oss_tpu.sim import batch as JB
from kueue_oss_tpu.sim import traces as JTR
from kueue_oss_tpu.sim.engine import WhatIfEngine as JaxEngine
from kueue_oss_tpu.sim.resident import ResidentSweep as JaxResident
from kueue_oss_tpu.solver import full_kernels as jfk
from kueue_oss_tpu_torch.config import SimulatorConfig
from kueue_oss_tpu_torch.sim import batch as B
from kueue_oss_tpu_torch.sim import traces as TR
from kueue_oss_tpu_torch.sim.engine import WhatIfEngine
from kueue_oss_tpu_torch.sim.resident import ResidentSweep
from kueue_oss_tpu_torch.solver import full_kernels as pfk
from kueue_oss_tpu_torch.solver.tensors import pow2
from torch_fullsweep_pins import (
    FULL_FIELDS,
    JAX,
    PORT,
    _mod,
    add_numbered,
    afs_store,
    contended_store,
    hetero_store,
    sweep_problem,
)

pytestmark = pytest.mark.sim

QUOTA = (0.25, 0.5, 1.5, 2.0, 3.0)
ARRIVAL = (0.5, 0.75, 1.5)


def _specs(root, n=9):
    sim = _mod(root, "sim")
    return sim.cross(sim.quota_sweep(QUOTA), sim.arrival_sweep(ARRIVAL))[:n]


def _rows(res, n: int):
    """The first ``n`` scenarios of a FULL result's plan fields."""
    return B.FullSweepResult(*[np.asarray(getattr(res, f))[:n]
                               for f in FULL_FIELDS])


def _same(a, b) -> list:
    """The FULL result fields where ``a`` differs from ``b``."""
    return [name for name in FULL_FIELDS
            if np.asarray(getattr(a, name)).dtype
            != np.asarray(getattr(b, name)).dtype
            or not np.array_equal(getattr(a, name), getattr(b, name))]


@pytest.fixture(scope="module")
def env():
    jstore, pstore = contended_store(JAX), contended_store(PORT)
    jp, W = sweep_problem(JAX, jstore)
    pp, _ = sweep_problem(PORT, pstore)
    jspecs, pspecs = _specs(JAX), _specs(PORT)
    caps = B.full_caps(pp)
    jtensors = jfk.to_device_full(jp)
    joverlays = [s.overlay(jp) for s in jspecs]
    seq = JB.solve_scenarios_sequential_full(jp, joverlays, *caps,
                                             tensors=jtensors)
    jchunk4 = JB.solve_scenarios_full(jp, joverlays[:8], *caps,
                                      tensors=jtensors, chunk=4)
    return dict(jstore=jstore, store=pstore, jproblem=jp, problem=pp,
                n_real=W, jspecs=jspecs, specs=pspecs, caps=caps,
                jcaps=JB.full_caps(jp), jtensors=jtensors,
                joverlays=joverlays,
                overlays=[s.overlay(pp) for s in pspecs],
                tensors=pfk.to_device_full(pp, "cpu"), seq=seq,
                jchunk4=jchunk4)


# ---------------------------------------------------------------------------
# the export and the batched drain against the JAX package
# ---------------------------------------------------------------------------


def test_host_tensors_full_match_jax_field_by_field(env):
    jh = jfk.host_tensors_full(env["jproblem"])
    ph = pfk.host_tensors_full(env["problem"])
    assert pfk.FullTensors._fields == jfk.FullTensors._fields
    for name in pfk.FullTensors._fields:
        a, b = np.asarray(getattr(jh, name)), np.asarray(getattr(ph, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert env["caps"] == env["jcaps"]
    assert pfk.FULL_WL_FIELDS == jfk.FULL_WL_FIELDS
    assert pfk.FULL_BATCHABLE_FIELDS == jfk.FULL_BATCHABLE_FIELDS
    assert pfk.ALL_FULL_FIELDS == jfk.ALL_FULL_FIELDS


def test_problem_is_preemption_shaped(env):
    p = env["problem"]
    assert p.wl_admitted0[:env["n_real"]].any()
    # the oracle sees preemptions somewhere in the sweep, or the parity
    # below proves nothing about victims
    assert (env["seq"].victim_reason[:, :env["n_real"]] > 0).any()


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_chunked_equals_sequential(env, chunk):
    full = B.solve_scenarios_full(
        env["problem"], env["overlays"], *env["caps"],
        tensors=env["tensors"], chunk=chunk)
    S = len(env["overlays"])
    tail = S % chunk
    assert full.chunks == [chunk] * (S // chunk) + (
        [pow2(tail)] if tail else [])
    if chunk == 4:
        # the JAX batch of the first 8 worlds: the same two chunks
        assert full.chunks[:2] == env["jchunk4"].chunks
        assert not _same(_rows(full, 8), env["jchunk4"])
    assert full.tier == env["seq"].tier == [B.FULL_TIER] * S
    assert not _same(full, env["seq"])
    # every round's live read and the inner loops' reads, one read-back
    # per chunk
    assert full.host_reads >= sum(c["rounds"] for c in full.chunk_stats)


def test_batched_drain_matches_jax_vmap_directly(env):
    """``solve_backlog_full_batched`` on the stacked overlays of two
    chunks against ``jit(vmap(_solve_full_impl))``'s outputs (the JAX
    width-4 sweep), the frozen lanes' round counts included."""
    stacked = B.to_full_fields(B.stack_overlays(env["problem"],
                                                env["overlays"][:4]))
    stats = pfk.FullDrainStats()
    out = pfk.solve_backlog_full_batched(env["tensors"], stacked,
                                         *env["caps"], stats=stats)
    assert len(out) == 8
    for name, got in zip(FULL_FIELDS, out):
        want = np.asarray(getattr(env["jchunk4"], name))[:4]
        # the outputs stay on the tensors' device until a sweep fetches
        assert got.device == torch.device("cpu")
        assert np.array_equal(got.numpy(), want), name
    rounds = out[4].numpy()
    assert out[4].dtype == torch.int32 and rounds.shape == (4,)
    # the batch runs to its slowest lane; the others froze earlier
    assert stats.rounds == int(rounds.max()) and rounds.min() < rounds.max()
    with pytest.raises(ValueError, match="scenario-varying"):
        pfk.solve_backlog_full_batched(env["tensors"], {}, *env["caps"])
    with pytest.raises(ValueError, match="not FullTensors fields"):
        pfk.solve_backlog_full_batched(env["tensors"], {"wl_rank": 1},
                                       *env["caps"])


def test_randomized_budgets_bitwise_identical(env):
    per = B.LaneBudget().lane_bytes(env["problem"], *env["caps"])
    assert per == JB.LaneBudget().lane_bytes(env["jproblem"], *env["caps"])
    order = B.sweep_order(env["specs"])
    assert order == JB.sweep_order(env["jspecs"])
    rng = np.random.default_rng(42)
    for w in rng.choice([1, 2, 3, 5, 8], size=3, replace=False):
        budget = B.LaneBudget(budget_bytes=int(per * w + per // 2))
        res = B.solve_scenarios_tiered(
            env["problem"], env["overlays"], budget=budget,
            caps=env["caps"], tensors=env["tensors"], order=order)
        assert res.tier == [B.FULL_TIER] * len(env["overlays"])
        assert res.retier_idx == [] and res.retier_reason is None
        assert not _same(res, env["seq"]), int(w)


def test_skew_order_dispatch_identical(env):
    order = B.sweep_order(env["specs"])
    assert sorted(order) == list(range(len(env["specs"])))
    full = B.solve_scenarios_full(
        env["problem"], env["overlays"], *env["caps"],
        tensors=env["tensors"], chunk=4, order=order)
    assert not _same(full, env["seq"])
    with pytest.raises(ValueError, match="permutation"):
        B.solve_scenarios_full(
            env["problem"], env["overlays"], *env["caps"],
            tensors=env["tensors"], order=[0] * len(env["overlays"]))


# ---------------------------------------------------------------------------
# lane-budget planner math + retier audit
# ---------------------------------------------------------------------------


def test_plan_math(env):
    per = B.LaneBudget().lane_bytes(env["problem"], *env["caps"])
    assert per > 0
    plan = B.LaneBudget(budget_bytes=per * 5).plan(9, env["problem"],
                                                   *env["caps"])
    jplan = JB.LaneBudget(budget_bytes=per * 5).plan(9, env["jproblem"],
                                                     *env["caps"])
    assert plan.chunk_width == jplan.chunk_width == 4
    assert plan.chunks == jplan.chunks == [(0, 4), (4, 4), (8, 1)]
    assert plan.full_count == 9 and not plan.relax_idx
    assert (B.LaneBudget(budget_bytes=per * 5).chunk_width_for(
        env["problem"], *env["caps"]) == 4)
    for S, lb in ((9, B.LaneBudget(budget_bytes=1)),
                  (300, B.LaneBudget())):
        got = lb.plan(S, env["problem"], *env["caps"])
        want = JB.LaneBudget(budget_bytes=lb.budget_bytes).plan(
            S, env["jproblem"], *env["caps"])
        assert vars(got) == vars(want)


def test_scenario_exceeds_budget_goes_relax(env, caplog):
    lb = B.LaneBudget(budget_bytes=1)
    with caplog.at_level("WARNING"):
        res = B.solve_scenarios_tiered(
            env["problem"], env["overlays"], budget=lb, caps=env["caps"],
            tensors=env["tensors"])
    assert "re-tiered 9/9" in caplog.text
    want = JB.solve_scenarios_tiered(
        env["jproblem"], env["joverlays"], budget=JB.LaneBudget(
            budget_bytes=1), caps=env["caps"], tensors=env["jtensors"])
    assert res.tier == want.tier == [B.RELAX_TIER] * 9
    assert res.retier_reason == want.retier_reason == (
        "scenario_exceeds_lane_budget")
    assert res.retier_idx == want.retier_idx == list(range(9))
    assert res.chunks == want.chunks == []
    assert not _same(res, want)


def test_sweep_above_cap_splits_tiers(env):
    lb = B.LaneBudget(max_full_scenarios=4)
    res = B.solve_scenarios_tiered(
        env["problem"], env["overlays"], budget=lb, caps=env["caps"],
        tensors=env["tensors"])
    want = JB.solve_scenarios_tiered(
        env["jproblem"], env["joverlays"], budget=JB.LaneBudget(
            max_full_scenarios=4), caps=env["caps"], tensors=env["jtensors"])
    assert res.tier == want.tier == [B.FULL_TIER] * 4 + [B.RELAX_TIER] * 5
    assert res.retier_reason == want.retier_reason == "sweep_above_full_cap"
    assert res.retier_idx == want.retier_idx == [4, 5, 6, 7, 8]
    assert res.chunks == want.chunks
    assert res.opt.shape == want.opt.shape
    assert not _same(res, want)
    # the FULL rows are the oracle's
    assert not _same(_rows(res, 4), _rows(env["seq"], 4))


# ---------------------------------------------------------------------------
# scenario-resident device state
# ---------------------------------------------------------------------------


def _lifecycle_store(root):
    gen = _mod(root, "perf.generator")
    cfg = gen.GeneratorConfig.large_scale(preemption=True)
    cfg.n_cohorts, cfg.cqs_per_cohort = 2, 2
    for wc, n in zip(cfg.classes, (4, 2, 1)):
        wc.count = n
    store, schedule = gen.generate(cfg)
    add_numbered(store, schedule[:-1])
    extra = schedule[-1].workload
    extra.uid = len(schedule)
    return store, extra


def _cold_parity(problem, dev):
    cold = pfk.host_tensors_full(problem)
    for name, a, b in zip(pfk.FullTensors._fields, dev, cold):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy().reshape(b.shape), b), name


def test_resident_lifecycle_and_invalidation():
    """full -> reuse -> scatter (churn) -> full (spec edit), each sync
    the JAX session's own, every resident tensor equal to a cold
    upload, and the resident tensors never alias the host copy."""
    stores = {root: _lifecycle_store(root) for root in (JAX, PORT)}
    rs = ResidentSweep(stores[PORT][0], device="cpu")
    jrs = JaxResident(stores[JAX][0])

    def step(mutate=None):
        for root in (JAX, PORT):
            if mutate:
                mutate(root, *stores[root])
        jp, _ = jrs.refresh()
        p, d = rs.refresh()
        _cold_parity(p, d)
        jh, ph = jfk.host_tensors_full(jp), pfk.host_tensors_full(p)
        for name in pfk.FullTensors._fields:
            assert np.array_equal(np.asarray(getattr(jh, name)),
                                  np.asarray(getattr(ph, name))), name
        return d

    d1 = step()
    assert rs.last_sync == "full" and rs.full_uploads == 1
    d2 = step()
    assert rs.last_sync == "reuse" and rs.reuses == jrs.reuses == 1
    assert d2 is d1 and rs.avoided_upload_bytes > 0

    def churn(root, store, extra):
        store.add_workload(extra)

    step(churn)
    assert rs.last_sync == "scatter"
    assert rs.full_uploads == jrs.full_uploads == 1
    assert rs.scatter_refreshes == jrs.scatter_refreshes == 1
    assert rs.scattered_rows == jrs.scattered_rows > 0

    def spec_edit(root, store, extra):
        cq = store.cluster_queues[next(iter(store.cluster_queues))]
        store.upsert_cluster_queue(cq)

    step(spec_edit)
    assert rs.full_uploads == jrs.full_uploads == 2, rs.stats()
    assert rs.resident_bytes() > 0 and rs.scatter_faults == 0
    assert set(rs.stats()) >= set(jrs.stats())


def test_resident_failed_row_write_heals_through_a_full_upload():
    store, extra = _lifecycle_store(PORT)
    rs = ResidentSweep(store, device="cpu")
    rs.refresh()
    bad = np.zeros(2, dtype=np.int64)
    with pytest.raises(ValueError, match="unique rows"):
        rs._write_rows(rs._dev.wl_prio, bad, np.zeros(2, np.int32))
    with pytest.raises(TypeError, match="dtype"):
        rs._write_rows(rs._dev.wl_prio, bad[:1], np.zeros(1, np.int64))
    # a churn whose row write fails: counted, healed, still exact
    store.add_workload(extra)
    rs._write_rows = lambda *a: (_ for _ in ()).throw(
        RuntimeError("device fault"))
    p, d = rs.refresh()
    assert rs.last_sync == "full" and rs.scatter_faults == 1
    assert rs.full_uploads == 2
    _cold_parity(p, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentSweep(store)


# ---------------------------------------------------------------------------
# engine wiring: tiers, KPIs, retier surfacing, residency
# ---------------------------------------------------------------------------


def test_full_run_parity_and_kpis_match_jax(env):
    rep = WhatIfEngine(env["store"], device="cpu").run(
        env["specs"][:4], parity=2, full=True)
    want = JaxEngine(env["jstore"]).run(env["jspecs"][:4], parity=2,
                                        full=True)
    assert rep.canonical_json() == want.canonical_json()
    assert rep.base["tier"] == "full"
    assert rep.parity["identical"] and rep.parity["checked"] == 2
    assert rep.base["full_caps"] == want.base["full_caps"]
    assert {row["tier"] for row in rep.scenarios} == {"full"}
    assert any(row["preemptions"] > 0 for row in rep.scenarios)
    for row in rep.scenarios:
        assert "cqs_at_borrow_ceiling" in row and "borrowing_cqs" in row
    assert rep.timing["full_chunks"] == want.timing["full_chunks"]
    assert rep.timing["batch_dispatches"] == want.timing["batch_dispatches"]


def test_retier_surfaced_in_report(env):
    """A FULL cap of 4 on 8 worlds (the JAX engine's width-4 program of
    the parity case): the last 4 rows re-tiered, named in the report."""
    rep = WhatIfEngine(env["store"], config=SimulatorConfig(
        full_sweep_max=4), device="cpu").run(env["specs"][:8], full=True)
    want = JaxEngine(env["jstore"], config=JaxSimulatorConfig(
        full_sweep_max=4)).run(env["jspecs"][:8], full=True)
    assert rep.canonical_json() == want.canonical_json()
    retier = rep.base.get("retier")
    assert retier and retier["reason"] == "sweep_above_full_cap"
    assert len(retier["scenarios"]) == 4
    assert [row["tier"] for row in rep.scenarios] == [
        "full"] * 4 + ["relax"] * 4


def _churn_store(root):
    """``contended_store`` with its last workload held back (returned
    beside the store) for a churn that keeps the export's shapes."""
    store = contended_store(root)
    extra = store.workloads[max(store.workloads,
                                key=lambda k: store.workloads[k].uid)]
    store.delete_workload(extra.key)
    assert extra.status.admission is None
    return store, extra


def test_config_full_kernel_and_resident_engine_match_jax():
    """``SimulatorConfig(full_kernel=True)`` and a resident engine: run,
    an idle rerun (reuse), then a churn (scatter), every report the JAX
    engine's (at the parity case's shapes, so its programs serve)."""
    stores = {root: _churn_store(root) for root in (JAX, PORT)}
    specs = {root: _specs(root, 4) for root in (JAX, PORT)}
    eng = WhatIfEngine(stores[PORT][0], config=SimulatorConfig(
        full_kernel=True), resident=True, device="cpu")
    jeng = JaxEngine(stores[JAX][0], config=JaxSimulatorConfig(
        full_kernel=True), resident=True)
    kinds = []
    for mutate in (False, False, True):
        if mutate:
            for root in (JAX, PORT):
                stores[root][0].add_workload(stores[root][1])
        rep = eng.run(specs[PORT], parity=2)
        want = jeng.run(specs[JAX], parity=2)
        assert rep.canonical_json() == want.canonical_json()
        assert rep.timing["full_chunks"] == want.timing["full_chunks"]
        kinds.append(eng.resident.last_sync)
    assert kinds == ["full", "reuse", "scatter"]
    assert eng.resident.stats()["full_uploads"] == (
        jeng.resident.stats()["full_uploads"])


def test_engine_full_path_defaults_to_cuda(env):
    with pytest.raises(RuntimeError, match="CUDA"):
        WhatIfEngine(env["store"], resident=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        B.solve_scenarios_full(env["problem"], env["overlays"][:1],
                               *env["caps"])
    with pytest.raises(RuntimeError, match="CUDA"):
        B.solve_scenarios_tiered(env["problem"], env["overlays"][:1],
                                 caps=env["caps"])


# ---------------------------------------------------------------------------
# more store shapes: two resource groups, admission fair sharing
# ---------------------------------------------------------------------------


def _sweep_against_jax(jp, pp, n_real, afs=False, pick=(0, 1, 2, 3)):
    jspecs = [_specs(JAX)[i] for i in pick]
    pspecs = [_specs(PORT)[i] for i in pick]
    caps = B.full_caps(pp)
    assert caps == JB.full_caps(jp)
    jh, ph = jfk.host_tensors_full(jp), pfk.host_tensors_full(pp)
    for name in pfk.FullTensors._fields:
        a, b = np.asarray(getattr(jh, name)), np.asarray(getattr(ph, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert bool(np.any(pp.cq_afs)) == afs
    want = JB.solve_scenarios_sequential_full(
        jp, [s.overlay(jp) for s in jspecs], *caps)
    got = B.solve_scenarios_full(pp, [s.overlay(pp) for s in pspecs],
                                 *caps, device="cpu")
    assert not _same(got, want)
    return caps, want


def test_two_resource_groups_match_jax():
    jp, W = sweep_problem(JAX, hetero_store(JAX))
    pp, _ = sweep_problem(PORT, hetero_store(PORT))
    caps, want = _sweep_against_jax(jp, pp, W, pick=(4, 6))
    assert caps[0] == 2          # the multi-group search re-run
    assert (want.victim_reason[:, :W] > 0).any()


def test_admission_fair_sharing_store_matches_jax():
    (js, jafs), (ps, pafs) = afs_store(JAX), afs_store(PORT)
    jp, W = sweep_problem(JAX, js, afs=jafs, now=60.0)
    pp, _ = sweep_problem(PORT, ps, afs=pafs, now=60.0)
    _, want = _sweep_against_jax(jp, pp, W, afs=True)
    assert want.admitted[:, :W].any()


# ---------------------------------------------------------------------------
# traces + the breaking-point ladder
# ---------------------------------------------------------------------------


def test_traces_deterministic_shaped_and_jax_equal():
    a = TR.philly_trace(60, seed=7)
    assert [j.to_dict() for j in a] == [
        j.to_dict() for j in TR.philly_trace(60, seed=7)]
    assert [j.to_dict() for j in a] == [
        j.to_dict() for j in JTR.philly_trace(60, seed=7)]
    assert len(a) == 60
    gpus = [j.gpus for j in a]
    assert min(gpus) == 1 and max(gpus) <= 32
    assert gpus.count(1) > len(gpus) * 0.3
    h = TR.helios_trace(60, seed=7)
    assert [j.to_dict() for j in h] != [j.to_dict() for j in a]
    assert [j.to_dict() for j in h] == [
        j.to_dict() for j in JTR.helios_trace(60, seed=7)]
    with pytest.raises(ValueError, match="unknown trace shape"):
        TR.synthetic_trace(4, shape="borg")


def test_trace_roundtrip(tmp_path):
    jobs = TR.philly_trace(24, seed=3)
    for name in ("t.jsonl", "t.csv"):
        path = str(tmp_path / name)
        TR.save_trace(path, jobs)
        back = TR.load_trace(path)
        assert [j.to_dict() for j in back] == [j.to_dict() for j in jobs]
        assert [j.to_dict() for j in JTR.load_trace(path)] == [
            j.to_dict() for j in jobs]


def test_load_trace_validates(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as fh:
        fh.write('{"job_id": "x"}\n')
    with pytest.raises(ValueError, match="missing fields"):
        TR.load_trace(path)


def test_store_from_trace_contended_and_jax_equal():
    jobs = TR.philly_trace(40, seed=5)
    store = TR.store_from_trace(jobs, capacity_frac=0.25)
    jstore = JTR.store_from_trace(JTR.philly_trace(40, seed=5),
                                  capacity_frac=0.25)
    assert len(store.workloads) == 40
    assert set(store.cluster_queues) == {j.vc for j in jobs}
    demand = sum(j.gpus for j in jobs)
    nominal = {name: [q.nominal for rg in cq.resource_groups
                      for fq in rg.flavors for q in fq.resources]
               for name, cq in store.cluster_queues.items()}
    assert sum(sum(v) for v in nominal.values()) < demand
    assert nominal == {name: [q.nominal for rg in cq.resource_groups
                              for fq in rg.flavors for q in fq.resources]
                       for name, cq in jstore.cluster_queues.items()}
    assert [(w.key, w.uid, w.priority, w.creation_time)
            for w in store.workloads.values()] == [
        (w.key, w.uid, w.priority, w.creation_time)
        for w in jstore.workloads.values()]
    with pytest.raises(ValueError, match="empty trace"):
        TR.store_from_trace([])


@pytest.mark.parametrize("full", [False, True])
def test_ladder_finds_breaking_point_like_jax(full):
    kw = dict(factors=(1, 2, 4), starvation_age_s=1000.0, full=full)
    res = TR.load_ladder(TR.store_from_trace(TR.philly_trace(40, seed=5)),
                         device="cpu", **kw)
    want = JTR.load_ladder(JTR.store_from_trace(
        JTR.philly_trace(40, seed=5)), **kw)
    assert res["report"].canonical_json() == want["report"].canonical_json()
    assert [r["factor"] for r in res["ladder"]] == [1.0, 2.0, 4.0]
    for key in ("first_slo_burn", "first_starvation_breach",
                "first_borrow_ceiling", "what_breaks_first"):
        assert res[key] == want[key], key
    for row in res["ladder"]:
        assert set(row["breaches"]) == {
            "slo_burn", "starvation_breach", "borrow_ceiling"}
    assert res["what_breaks_first"] is not None
    for key in ("slo_burn", "starvation_breach", "borrow_ceiling"):
        hits = [r["factor"] for r in res["ladder"] if r["breaches"][key]]
        assert res[f"first_{key}"] == (min(hits) if hits else None)


def test_chip_smoke_copies_match_the_pins_helpers():
    """chip_smoke.py keeps its own copies of phase 19's worlds: the trace
    store and its export, the 64 specs, the removal and the constants."""
    import chip_smoke
    import torch_fullsweep_pins as pins

    for name in ("FULLSWEEP_QUOTA", "FULLSWEEP_ARRIVAL", "FULLSWEEP_S",
                 "FULLSWEEP_JOBS", "FULLSWEEP_CHUNK", "ENGINE_REMOVED",
                 "ENGINE_WORLDS", "ENGINE_ARRIVAL", "FULL_FIELDS"):
        assert getattr(chip_smoke, name) == getattr(pins, name), name
    problem, W, specs, overlays, order = chip_smoke.fullsweep_problem(32)
    want, W2 = sweep_problem(PORT, pins.trace_store(PORT, 32))
    assert W == W2
    for name, a, b in zip(pfk.FullTensors._fields,
                          pfk.host_tensors_full(problem),
                          pfk.host_tensors_full(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert [s.name for s in specs] == [
        s.name for s in pins.fullsweep_specs(PORT)]
    assert order == B.sweep_order(specs)
    store = pins.engine_store(PORT)
    assert chip_smoke._engine_removed(store) == pins.engine_removed(store)
    assert len(pins.engine_removed(store)) == 75
