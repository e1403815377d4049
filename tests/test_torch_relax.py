"""The port's relaxed LP arm (``kueue_oss_tpu_torch/solver/relax.py``,
``solver/cuda_relax.py``, the engine's relaxed arm, the scheduler's
``solver_config`` and ``sim.solve_scenarios_relax``) against the JAX
package on the CPU, on the same seeded stores.

Tolerance 0 throughout: the LP tensors field by field, x bit for bit
(two- and three-level cohort trees, one and three flavor-resources and
dense LPs of four, five and eight, 32 and 30 iterations, and four
scenarios against the JAX ``vmap``), the kernel's index and its cut into
cluster blocks, the
rounded support, the repair's and the whole arm's plans, and the
engine's plans and relax counts (served, audited, demoted by a seeded
divergence and re-probed after the cooldown, faulted through to the
exact arm, and the router's probe rules). x is compared with the JAX
program as tier-1 compiles it (tests/conftest.py caps XLA:CPU at AVX,
so it fuses no multiply-add); ``relax.sum_order`` is its order of the
sum over the flavor-resources.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import functools

import jax
import numpy as np
import pytest
import torch

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.config.configuration import (
    SolverBackendConfig as JaxSolverConfig,
)
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu.solver import relax as jax_relax
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import pad_workloads as jax_pad
from kueue_oss_tpu_torch import scenarios
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.config import SolverBackendConfig
from kueue_oss_tpu_torch.core.eviction import finish_workload
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PortScheduler
from kueue_oss_tpu_torch.solver import cuda_relax
from kueue_oss_tpu_torch.solver import relax
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.tensors import pad_workloads, pow2
from torch_relax_pins import (
    JAX,
    PORT,
    RelaxCounts,
    churn_record,
    exact_plan,
    large_scale_problems,
    relax_arm_record,
    relax_tier_record,
)

pytestmark = pytest.mark.relax

RESOURCES = {1: ("cpu",), 3: ("cpu", "memory", "gpu")}


def _store(types, store_cls, levels=2, n_res=1, n_cqs=4, quota=8,
           n_wl=64, seed=0, strict=()):
    """A contended fit-only store: ``n_cqs`` ClusterQueues in a cohort
    tree of ``levels`` levels (2: two root cohorts; 3: one root over
    two cohorts), every third borrowing-limited, ``n_wl`` seeded
    workloads with ``n_res`` resources."""
    rng = np.random.default_rng(seed)
    res = RESOURCES[n_res]
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    if levels == 3:
        store.upsert_cohort(types.Cohort(name="root"))
    for k in range(2):
        store.upsert_cohort(types.Cohort(
            name=f"co{k}", parent="root" if levels == 3 else None))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", cohort=f"co{i % 2}",
            queueing_strategy=("StrictFIFO" if i in strict
                               else "BestEffortFIFO"),
            resource_groups=[types.ResourceGroup(
                covered_resources=list(res),
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(
                        name=r, nominal=quota * (1 + j),
                        borrowing_limit=(2 if i % 3 == 0 else None))
                    for j, r in enumerate(res)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    for i in range(n_wl):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % n_cqs}", uid=i + 1,
            priority=int(rng.integers(0, 3)), creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1, requests={
                r: int(rng.integers(1, 4)) * (1 + j)
                for j, r in enumerate(res)})]))
    return store


def _pair(**kw):
    return (_store(jax_types, JaxStore, **kw),
            _store(port_types, PortStore, **kw))


def _problems(**kw):
    """The padded lean exports of the same store by both packages."""
    jstore, pstore = _pair(**kw)
    jp, _ = JaxEngine(jstore, JaxQueues(jstore), mesh_mode="off").export()
    pp, _ = PortEngine(pstore, PortQueues(pstore), device="cpu").export()
    return (jax_pad(jp, pow2(jp.n_workloads)),
            pad_workloads(pp, pow2(pp.n_workloads)))


def _lp_x(lp, iters):
    return relax.lp_loop(relax.lp_to_device(relax.RelaxLP(*lp), "cpu"),
                         iters).numpy()


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


SHAPES = [dict(levels=lv, n_res=f, n_cqs=nc, n_wl=nw, seed=sd)
          for lv, f, nc, nw, sd in ((2, 1, 4, 64, 0), (3, 1, 6, 150, 1),
                                    (2, 3, 5, 100, 2), (3, 3, 6, 200, 3))]
SHAPE_IDS = [f"L{s['levels']}-F{s['n_res']}" for s in SHAPES]
#: the LPs of the bit-for-bit tests: SHAPES, and dense LPs (every column
#: non-zero) widened from the three-resource shapes, where the order of
#: the sum over the columns shows: a case for each branch of
#: ``relax.sum_order`` (F <= 3 in order, 4-8 in halves, V = 4 at 9-12,
#: V = 8 at 13-15, E = 4 * (F // 4) above 16 with its in-order tail)
LP_CASES = SHAPES + [dict(SHAPES[k], dense=f)
                     for k, f in ((2, 4), (3, 5), (3, 8), (2, 9), (3, 12),
                                  (2, 13), (3, 16), (2, 17), (3, 20),
                                  (2, 23), (3, 32))]
LP_IDS = SHAPE_IDS + [f"L{c['levels']}-dense-F{c['dense']}"
                      for c in LP_CASES[len(SHAPES):]]


def _lps(case):
    """(JAX LP, port LP) of a case, widened alike when it is dense."""
    case = dict(case)
    dense = case.pop("dense", None)
    jp, pp = _problems(**case)
    jlp, plp = jax_relax.build_lp(jp), relax.build_lp(pp)
    if dense:
        jlp = scenarios.dense_relax_lp(jlp, dense, case["seed"])
        plp = scenarios.dense_relax_lp(plp, dense, case["seed"])
    return jlp, plp


# ---------------------------------------------------------------------------
# the LP: build_lp, lp_loop, the kernel's CPU path and its index lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_build_lp_matches_jax(shape):
    jp, pp = _problems(**shape)
    jlp, plp = jax_relax.build_lp(jp), relax.build_lp(pp)
    assert plp.r.shape[1] == shape["n_res"]
    assert plp.path_cq.shape[1] == shape["levels"]
    for name in relax.RelaxLP._fields:
        a, b = getattr(jlp, name), getattr(plp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("iters", [32, 30])
@pytest.mark.parametrize("shape", LP_CASES, ids=LP_IDS)
def test_lp_loop_bit_identical_to_jax(shape, iters):
    jlp, plp = _lps(shape)
    want = np.asarray(jax_relax._single_lp(iters)(jlp))
    got = _lp_x(plp, iters)
    assert _same_bits(got, want)
    # the LP is not trivial: every live row moved off its start of 0.5,
    # and a share of them ends strictly inside (0, 1)
    live = plp.live
    assert (got[live] != 0.5).all()
    assert ((got[live] > 0) & (got[live] < 1)).mean() > 0.1


@pytest.mark.parametrize("n_res", [1, 3, 4, 8, 12, 17])
def test_lp_loop_batched_bit_identical_to_jax_vmap(n_res):
    """Four scenarios (seeds) stacked on a leading axis against the JAX
    package's ``jit(vmap(lp_loop))``; four columns and more are dense
    LPs widened from three resources."""
    lps = [relax.build_lp(_problems(levels=3, n_res=min(n_res, 3), n_cqs=6,
                                    n_wl=100, seed=s)[1]) for s in range(4)]
    if n_res > 3:
        lps = [scenarios.dense_relax_lp(lp, n_res, s)
               for s, lp in enumerate(lps)]
    stacked = relax.RelaxLP(*[np.stack([getattr(lp, f) for lp in lps])
                              for f in relax.RelaxLP._fields])
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        jax_relax.lp_loop, iters=32)))(jax_relax.RelaxLP(*stacked)))
    got = _lp_x(stacked, 32)
    assert got.shape == (4, stacked.r.shape[1])
    assert _same_bits(got, want)
    # each scenario alone gives its row of the batch
    for i, lp in enumerate(lps):
        assert _same_bits(_lp_x(lp, 32), got[i])


#: dense LPs above 32 columns, where XLA:CPU splits the sum over F into
#: a reduce-window of 32 and a reduce (``relax.sum_order``'s (0, P)
#: branch): each F at two row counts (W+1 = 129 and 257) for one LP
WIDE = [(f, nw) for f in (33, 40, 48, 64, 96, 128) for nw in (100, 200)]
WIDE_IDS = [f"F{f}-W{nw}" for f, nw in WIDE]


@pytest.mark.parametrize("n_cols,n_wl", WIDE, ids=WIDE_IDS)
def test_lp_loop_bit_identical_to_jax_above_32_columns(n_cols, n_wl):
    jp, pp = _problems(levels=3, n_res=3, n_cqs=6, n_wl=n_wl, seed=3)
    jlp = scenarios.dense_relax_lp(jax_relax.build_lp(jp), n_cols, 3)
    plp = scenarios.dense_relax_lp(relax.build_lp(pp), n_cols, 3)
    want = np.asarray(jax_relax._single_lp(32)(jlp))
    got = _lp_x(plp, 32)
    assert _same_bits(got, want)
    live = plp.live
    assert ((got[live] > 0) & (got[live] < 1)).mean() > 0.1


#: the vmap cases: every F above 32, the two row counts alternating
WIDE_VMAP = [(f, (100, 200)[k % 2])
             for k, f in enumerate((33, 40, 48, 64, 96, 128))]


@pytest.mark.parametrize("n_cols,n_wl", WIDE_VMAP,
                         ids=[f"F{f}-W{nw}" for f, nw in WIDE_VMAP])
def test_lp_loop_batched_bit_identical_to_jax_vmap_above_32_columns(
        n_cols, n_wl):
    """Two dense scenarios above 32 columns against ``jit(vmap(
    lp_loop))``: the window split is the same under the vmap."""
    lps = [scenarios.dense_relax_lp(relax.build_lp(_problems(
        levels=3, n_res=3, n_cqs=6, n_wl=n_wl, seed=s)[1]), n_cols, s)
        for s in range(2)]
    stacked = relax.RelaxLP(*[np.stack([getattr(lp, f) for lp in lps])
                              for f in relax.RelaxLP._fields])
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        jax_relax.lp_loop, iters=32)))(jax_relax.RelaxLP(*stacked)))
    assert _same_bits(_lp_x(stacked, 32), want)


#: above 128 columns: XLA:CPU's reduce-window of 32 up to 32 windows
#: (read at every width here; ``sum_order`` is checked at each)
WIDER = (129, 200, 256, 512, 1024)
#: the JAX parity cases, one compiled program each: LPs whose prices
#: stay positive and x interior for all 32 iterations
#: (``scenarios.interior_relax_lp``: there the windowed order and a
#: plain in-order sum give different x, so the pins can fail) inside
#: the windows' range, with front padding, and at 32 windows; a dense
#: LP with padding on both sides
WIDER_CASES = [("interior", 64), ("interior", 129), ("dense", 200),
               ("interior", 1024)]


def _in_order_x(lp):
    """x with the pull summed over the columns plainly in order, the
    order the windowed one must differ from."""
    windowed = relax.sum_in_order

    def in_order(prod):
        out = torch.zeros(prod.shape[:-1], dtype=prod.dtype)
        for f in range(prod.shape[-1]):
            out = out + prod[..., f]
        return out

    relax.sum_in_order = in_order
    try:
        return _lp_x(lp, 32)
    finally:
        relax.sum_in_order = windowed


@pytest.mark.parametrize("kind,n_cols", WIDER_CASES,
                         ids=[f"{k}-F{f}" for k, f in WIDER_CASES])
def test_lp_loop_bit_identical_to_jax_above_128_columns(kind, n_cols):
    make = (scenarios.interior_relax_lp if kind == "interior"
            else scenarios.dense_relax_lp)
    jp, pp = _problems(levels=3, n_res=3, n_cqs=6, n_wl=100, seed=3)
    jlp = make(jax_relax.build_lp(jp), n_cols, 3)
    plp = make(relax.build_lp(pp), n_cols, 3)
    want = np.asarray(jax_relax._single_lp(32)(jlp))
    got = _lp_x(plp, 32)
    assert _same_bits(got, want)
    live = plp.live
    assert ((got[live] > 0) & (got[live] < 1)).mean() > 0.1
    if kind == "interior":
        # every live x interior, and the order of the sum reaches it
        assert ((got[live] > 0) & (got[live] < 1)).all()
        assert not _same_bits(_in_order_x(plp), got)


@pytest.mark.parametrize("n_cols", [200], ids=["F200"])
def test_lp_loop_batched_bit_identical_to_jax_vmap_above_128_columns(
        n_cols):
    """Two interior scenarios against ``jit(vmap(lp_loop))``: the split
    into windows is the same under the vmap above 128 columns."""
    lps = [scenarios.interior_relax_lp(relax.build_lp(_problems(
        levels=3, n_res=3, n_cqs=6, n_wl=100, seed=s)[1]), n_cols, s)
        for s in range(2)]
    stacked = relax.RelaxLP(*[np.stack([getattr(lp, f) for lp in lps])
                              for f in relax.RelaxLP._fields])
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        jax_relax.lp_loop, iters=32)))(jax_relax.RelaxLP(*stacked)))
    got = _lp_x(stacked, 32)
    assert _same_bits(got, want)
    assert not _same_bits(_in_order_x(stacked), got)


def test_relax_lp_takes_the_plain_loop_on_cpu_and_counts_no_launch():
    _, pp = _problems(**SHAPES[3])
    lp = relax.lp_to_device(relax.build_lp(pp), "cpu")
    before = cuda_relax.relax_lp.launches
    assert _same_bits(cuda_relax.relax_lp(lp, 32).numpy(),
                      relax.lp_loop(lp, 32).numpy())
    assert cuda_relax.relax_lp.launches == before


def test_lp_index_lists_rows_by_cq_and_children_by_parent():
    """The kernel's per-CQ row lists and per-node child lists: ascending
    rows within each CQ (the order the segment sums add in), every row
    with wl_cqid < C once, and each node's in-range children."""
    _, pp = _problems(**SHAPES[1])
    lp = relax.build_lp(pp)
    C = pp.n_cqs
    index = cuda_relax.lp_index(lp.wl_cqid, lp.parent, lp.cq_node, C,
                                live=lp.live)
    rows, row_off, kids, kid_off, node_cq = (a[0] for a in index[:5])
    for c in range(C):
        got = rows[row_off[c]:row_off[c + 1]]
        assert np.array_equal(got, np.nonzero(lp.wl_cqid == c)[0])
    assert row_off[-1] == int((lp.wl_cqid < C).sum())
    # every row once, the padding id last
    assert np.array_equal(np.sort(rows), np.arange(lp.wl_cqid.shape[0]))
    assert (lp.wl_cqid[rows[row_off[-1]:]] == C).all()
    for n in range(lp.parent.shape[0]):
        assert np.array_equal(kids[kid_off[n]:kid_off[n + 1]],
                              np.nonzero(lp.parent == n)[0])
    assert np.array_equal(node_cq[lp.cq_node], np.arange(C))
    assert (np.delete(node_cq, lp.cq_node) == -1).all()
    with pytest.raises(ValueError):
        cuda_relax.lp_index(lp.wl_cqid, lp.parent,
                            np.zeros_like(lp.cq_node), C, live=lp.live)
    live = lp.live.copy()
    live[-1] = True  # the padding row, which the kernel never prices
    with pytest.raises(ValueError, match="live row"):
        cuda_relax.lp_index(lp.wl_cqid, lp.parent, lp.cq_node, C, live=live)


def _large_index_inputs(n_rows=65537, n_cqs=1000, seed=7):
    """The main path's LP shape without a store: ``n_rows`` rows over
    ``n_cqs`` ClusterQueues of uneven size (the last fifth padding), the
    ClusterQueues under ten cohorts; ``lp_index``'s arguments."""
    rng = np.random.default_rng(seed)
    cqid = rng.integers(0, n_cqs, size=n_rows).astype(np.int32)
    cqid[-(n_rows // 5):] = n_cqs
    parent = np.concatenate([np.arange(n_cqs) // (n_cqs // 10) + n_cqs,
                             np.full(11, -1)]).astype(np.int32)
    return (cqid, parent, np.arange(n_cqs, dtype=np.int32), n_cqs,
            cqid < n_cqs)


def test_cluster_partition_keeps_whole_cqs_in_row_order_and_balances_rows():
    """The kernel's cut of a scenario's ClusterQueues into the blocks of
    its cluster: contiguous ranges that hold every ClusterQueue exactly
    once, each ClusterQueue's rows in ascending row order inside its
    block's range, and blocks within one ClusterQueue of an even share
    of the rows. Other cluster sizes than ``cluster_size`` could pick
    raise."""
    cases = []
    for shape in SHAPES:
        lp = relax.build_lp(_problems(**shape)[1])
        cases.append((lp.wl_cqid, lp.parent, lp.cq_node,
                      lp.cq_node.shape[0], lp.live))
    cases.append(_large_index_inputs())
    for cqid, parent, cq_node, C, live in cases:
        for k in (0, 3, 16, C + 1):
            with pytest.raises(ValueError, match="cluster"):
                cuda_relax.lp_index(cqid, parent, cq_node, C, live,
                                    cluster=k)
        for k in (1, 2, 4, 8):
            if k > C:
                continue
            index = cuda_relax.lp_index(cqid, parent, cq_node, C, live,
                                        cluster=k)
            assert index.cluster == k
            part, row_off = index.part[0], index.row_off[0]
            rows = index.rows[0]
            assert part[0] == 0 and part[-1] == C
            assert (np.diff(part) >= 1).all()  # every block owns a CQ
            block_rows = np.diff(row_off[part])
            assert block_rows.sum() == row_off[-1]
            assert (block_rows.max()
                    <= row_off[-1] / k + np.diff(row_off).max())
            assert index.max_rows == max(1, int(block_rows.max()))
            assert index.max_cqs == int(np.diff(part).max())
            for j in range(k):
                for c in range(part[j], part[j + 1]):
                    a, z = row_off[c], row_off[c + 1]
                    assert row_off[part[j]] <= a <= z <= row_off[part[j + 1]]
                    assert np.array_equal(rows[a:z], np.nonzero(cqid == c)[0])


def test_cluster_size_and_layout_follow_the_shape():
    """Eight blocks for the main path's LPs, one for the relax tier's 32
    small worlds; the rows in shared memory at one column, r in global
    memory at eight, everything but the tree past that."""
    assert cuda_relax.cluster_size(1, 65537, 1000) == 8
    assert cuda_relax.cluster_size(1, 16385, 30) == 8
    assert cuda_relax.cluster_size(32, 257, 8) == 1
    assert cuda_relax.cluster_size(1, 2048, 30) == 1
    assert cuda_relax.cluster_size(1, 65537, 3) == 2
    cqid, parent, cq_node, C, live = _large_index_inputs()
    index = cuda_relax.lp_index(cqid, parent, cq_node, C, live)
    N1 = parent.shape[0]
    assert index.cluster == 8
    assert cuda_relax.layout(index, 1, N1) == (0, 0)
    assert cuda_relax.layout(index, 8, N1) == (1, 0)
    assert cuda_relax.block_threads(index, 1, N1) == 1024
    small = cuda_relax.lp_index(*_large_index_inputs(n_rows=1025, n_cqs=20))
    # one block of 820 rows: 26 warps
    assert small.cluster == 1 and small.max_rows == 820
    assert cuda_relax.block_threads(small, 1, 31) == 832
    wide = cuda_relax.lp_index(*_large_index_inputs(n_rows=400_000))
    assert cuda_relax.layout(wide, 1, N1) == (1, 1)
    with pytest.raises(ValueError, match="tree"):
        cuda_relax.layout(index, 64, N1)


def test_lane_width_and_rho_follow_xla():
    """``sum_order`` is the (lanes, vectorised prefix) read from XLA:CPU's
    LLVM IR, and above 32 columns the reduce-window's front padding;
    ``sum_in_order`` adds in that order: F = 4 is (m0 + m2) + (m1 + m3),
    F = 17 the eight-lane fold of the first 16, then m16, F = 33 two
    windows of 32 over the padded row, each in order."""
    assert [relax.sum_order(n) for n in (1, 2, 3, 4, 5, 8, 9, 12, 13, 16,
                                         17, 20, 23, 24, 28, 32)] == [
        (1, 1), (2, 2), (4, 3), (4, 4), (8, 5), (8, 8), (4, 9), (4, 12),
        (8, 13), (8, 16), (8, 16), (4, 20), (4, 20), (8, 24), (4, 28),
        (8, 32)]
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.random((64, 17), dtype=np.float32))
    f32 = np.float32
    v = m.numpy()
    want4 = (f32(v[:, 0] + v[:, 2]) + f32(v[:, 1] + v[:, 3]))
    assert _same_bits(relax.sum_in_order(m[:, :4]).numpy(), want4)
    lanes = [v[:, j] + v[:, j + 8] for j in range(8)]
    fold = [lanes[j] + lanes[j + 4] for j in range(4)]
    fold = [fold[0] + fold[2], fold[1] + fold[3]]
    want17 = (fold[0] + fold[1]) + v[:, 16]
    assert _same_bits(relax.sum_in_order(m).numpy(), want17)
    # above 32 columns: XLA's reduce-window of 32 with P = (pad // 2)
    # in front (read from the dumps: pad=0_0x15_16 at F = 33, 12_12 at
    # 40, 8_8 at 48, none at 64, 96 and 128); wider than the tests hold
    # (MAX_SUM_COLUMNS), it refuses
    assert [relax.sum_order(n) for n in (33, 40, 48, 64, 96, 128)] == [
        (0, 15), (0, 12), (0, 8), (0, 0), (0, 0), (0, 0)]
    # the same split up to 32 windows (read at 129, 256, 512 and 1,024:
    # pad=0_0x15_16 at 129, none at 256 and above)
    assert [relax.sum_order(n) for n in (129, 200, 256, 512, 1024)] == [
        (0, 15), (0, 12), (0, 0), (0, 0), (0, 0)]
    assert relax.MAX_SUM_COLUMNS == max(WIDER) == 32 * relax.WINDOW
    for n in (relax.MAX_SUM_COLUMNS + 1, 2048):
        with pytest.raises(ValueError, match="held only up to 1024"):
            relax.sum_order(n)
    w = torch.as_tensor(rng.random((64, 33), dtype=np.float32)).numpy()
    win0 = f32(0.0)
    for f in range(17):                   # padded 15 + elements 0..16
        win0 = f32(win0 + w[:, f])
    win1 = f32(0.0)
    for f in range(17, 33):               # elements 17..32 + padded 16
        win1 = f32(win1 + w[:, f])
    want33 = f32(f32(f32(0.0) + win0) + win1)
    assert _same_bits(relax.sum_in_order(torch.as_tensor(w)).numpy(),
                      want33)
    assert relax.rho_step(32) == np.float32(0.09375)
    # 3 * (1 / 30) in float32 is not float32(3 / 30)
    assert relax.rho_step(30) != np.float32(0.1)


# ---------------------------------------------------------------------------
# rounding, repair, the whole arm, plans_agree
# ---------------------------------------------------------------------------


def _plans_equal(a, b):
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("shape", SHAPES + [dict(
    levels=2, n_res=1, n_cqs=4, n_wl=60, seed=5, strict=(0,))],
    ids=SHAPE_IDS + ["strict"])
def test_support_repair_and_solve_relaxed_match_jax(shape):
    jp, pp = _problems(**shape)
    jout, jstats = jax_relax.solve_relaxed(jp)
    pout, pstats = relax.solve_relaxed(pp, device="cpu")
    assert _same_bits(pstats.x, jstats.x)
    jlp, plp = jax_relax.build_lp(jp), relax.build_lp(pp)
    jsel = jax_relax.rounded_support(jstats.x, jp, jlp.live)
    psel = relax.rounded_support(pstats.x, pp, plp.live)
    assert np.array_equal(psel, jsel)
    assert np.array_equal(relax.strict_rows(pp), jax_relax.strict_rows(jp))
    assert _plans_equal(pout, jout)
    for k in ("live", "support", "support_padded", "iters",
              "repair_rounds"):
        assert getattr(pstats, k) == getattr(jstats, k), k
    # the repair alone, with a sticky pad above the support
    pad = pow2(int(psel.sum()) + 1) * 2 - 1
    jrep, _ = jax_relax.repair(jp, jsel, jlp.live, pad_to=pad)
    prep, pst = relax.repair(pp, psel, plp.live, pad_to=pad, device="cpu")
    assert _plans_equal(prep, jrep) and pst.support_padded == pad
    # the arm's plan passes the JAX engine's plan guard unchanged
    assert JaxEngine._plan_fault(pp, pout[0], pout[1], pout[2], pout[3],
                                 None, pout[4], False) is None


def test_plans_agree_matches_jax():
    jp, pp = _problems(**SHAPES[2])
    exact = exact_plan(PORT, pp)
    W = pp.n_workloads
    adm = np.nonzero(exact[0][:W])[0]
    flipped = tuple(np.array(a, copy=True) for a in exact)
    flipped[0][adm[0]] = False
    flipped[3][adm[0]] = True
    other_opt = tuple(np.array(a, copy=True) for a in exact)
    other_opt[1][adm[0]] += 1
    rounds_only = tuple(np.array(a, copy=True) for a in exact)
    rounds_only[2][adm] += 5
    pad_only = tuple(np.array(a, copy=True) for a in exact)
    pad_only[0][-1] = True
    cases = [(exact, True), (flipped, False), (other_opt, False),
             (rounds_only, True), (pad_only, True)]
    for plan, want in cases:
        assert relax.plans_agree(plan, exact, W) is want
        assert jax_relax.plans_agree(plan, exact, W) is want


# ---------------------------------------------------------------------------
# the engine's relaxed arm (tests/test_relax.py's engine cases)
# ---------------------------------------------------------------------------


class _Side:
    """One package's engine over the uniform store of tests/test_relax.py
    (4 ClusterQueues x nominal 8, 1-cpu workloads)."""

    def __init__(self, port: bool, n_wl=64, **knobs):
        types, store_cls = ((port_types, PortStore) if port
                            else (jax_types, JaxStore))
        self.port = port
        self.store = store_cls()
        self.store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
        for i in range(4):
            self.store.upsert_cluster_queue(types.ClusterQueue(
                name=f"cq{i}", resource_groups=[types.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[types.FlavorQuotas(name="f", resources=[
                        types.ResourceQuota(name="cpu", nominal=8)])])]))
            self.store.upsert_local_queue(types.LocalQueue(
                name=f"lq{i}", cluster_queue=f"cq{i}"))
        for i in range(n_wl):
            self.store.add_workload(types.Workload(
                name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
                creation_time=float(i),
                podsets=[types.PodSet(name="main", count=1,
                                      requests={"cpu": 1})]))
        if port:
            self.queues = PortQueues(self.store)
            self.engine = PortEngine(self.store, self.queues, device="cpu")
        else:
            self.queues = JaxQueues(self.store)
            self.sched = JaxScheduler(self.store, self.queues)
            self.engine = JaxEngine(self.store, self.queues,
                                    scheduler=self.sched, mesh_mode="off")
        self.engine.relax_force = True
        self.engine.relax_audit_every = 0
        for k, v in knobs.items():
            setattr(self.engine, k, v)
        self.counts = RelaxCounts(PORT if port else JAX, self.engine)

    def finish_some(self, n, now):
        keys = [k for k, w in self.store.workloads.items()
                if w.is_quota_reserved and not w.is_finished][:n]
        for k in keys:
            if self.port:
                finish_workload(self.store, self.queues, k, now)
            else:
                self.sched.finish_workload(k, now=now)

    def parked(self):
        return {n: sorted(q.inadmissible) for n, q in
                self.queues.queues.items()}


def _both(**knobs):
    return _Side(False, **knobs), _Side(True, **knobs)


def test_engine_relax_drain_commits_with_no_oracle_rejection():
    j, p = _both()
    rejected0 = jax_metrics.solver_plan_fallbacks_total.total()
    jr = j.engine.drain(now=0.0, verify=True)
    pr = p.engine.drain(now=0.0, verify=True)
    assert p.engine.last_drain_arm == j.engine.last_drain_arm == "relax"
    assert pr.admitted == jr.admitted == 32
    assert pr.admitted_keys == jr.admitted_keys
    assert pr.plan_fallbacks == 0 and pr.verified == 32
    assert jax_metrics.solver_plan_fallbacks_total.total() == rejected0
    assert p.parked() == j.parked()
    assert sum(len(v) for v in p.parked().values()) == 32
    assert p.counts.take() == j.counts.take()
    assert p.counts.take()["served"] == 1
    assert {"relax_lp", "relax_repair", "solve"} <= set(pr.phases)


def test_engine_relax_plan_passes_the_plan_guard_unchanged():
    """The served plan, captured inside the drain, passes the JAX
    engine's ``_plan_fault`` guard as an imported plan would."""
    p = _Side(True, n_wl=48)
    inner = p.engine._local_solve
    checked = []

    def guarded(problem, frame, result, n_live):
        out = inner(problem, frame, result, n_live)
        assert JaxEngine._plan_fault(problem, out[0], out[1], out[2],
                                     out[3], None, out[4], False) is None
        checked.append(p.engine.last_drain_arm)
        return out

    p.engine._local_solve = guarded
    p.engine.drain(now=0.0)
    assert checked == ["relax"]


def test_audit_match_emits_the_exact_plan_and_counts():
    j, p = _both(relax_audit_every=1)
    jr = j.engine.drain(now=0.0)
    pr = p.engine.drain(now=0.0)
    assert pr.admitted == jr.admitted == 32
    assert pr.admitted_keys == jr.admitted_keys
    assert p.engine.last_relax_audit is j.engine.last_relax_audit is True
    assert p.engine.last_drain_arm == "single"
    assert p.counts.take() == j.counts.take()
    assert p.counts.take()["audit_match"] == 1
    assert not p.engine._relax_broken


def test_seeded_divergence_demotes_the_arm_and_reprobes_after_cooldown():
    """Corrupt the relaxed plan (drop one seeded admitted row) on an
    audited drain in both packages: the audit demotes the arm, counts
    the fallback and emits the exact plan; while demoted the arm never
    engages; after the cooldown one probe drain re-measures it."""
    j, p = _both(relax_audit_every=1)

    def corrupting(mod, rng):
        real = mod.solve_relaxed

        def corrupt(problem, **kw):
            out, stats = real(problem, **kw)
            admitted = np.asarray(out[0]).copy()
            parked = np.asarray(out[3]).copy()
            hit = rng.choice(np.nonzero(admitted[:-1])[0])
            admitted[hit] = False
            parked[hit] = True
            return (admitted, out[1], out[2], parked, out[4],
                    out[5]), stats
        return real, corrupt

    results = {}
    for side, mod in ((j, jax_relax), (p, relax)):
        real, corrupt = corrupting(mod, np.random.default_rng(7))
        mod.solve_relaxed = corrupt
        try:
            first = side.engine.drain(now=0.0)
        finally:
            mod.solve_relaxed = real
        assert first.admitted == 32
        assert side.engine.last_relax_audit is False
        assert side.engine._relax_broken
        side.finish_some(8, now=1.0)
        second = side.engine.drain(now=1.0)
        assert side.engine.last_drain_arm != "relax"
        side.engine._relax_broken_at -= side.engine.relax_retry_cooldown_s + 1
        side.finish_some(8, now=2.0)
        third = side.engine.drain(now=2.0)
        assert not side.engine._relax_broken
        assert side.engine.last_relax_audit is True
        results[side.port] = ([r.admitted_keys for r in (first, second,
                                                         third)],
                              side.counts.take(), side.parked())
    assert results[True] == results[False]
    taken = results[True][1]
    assert taken["relax_disagreement"] == 1
    assert taken["audit_diverged"] == 1 and taken["audit_match"] == 1


def test_relax_fault_falls_through_to_the_exact_arm():
    j, p = _both()

    def boom(arm):
        if arm == "relax":
            raise RuntimeError("injected relax fault")

    out = []
    for side in (j, p):
        side.engine.solve_fault_hook = boom
        r = side.engine.drain(now=0.0)
        assert r.admitted == 32
        assert side.engine.last_drain_arm == "single"
        assert side.engine._relax_broken
        out.append((r.admitted_keys, side.counts.take()))
    assert out[0] == out[1]
    assert out[1][1]["relax_error"] == 1 and out[1][1]["error"] == 1


def test_router_probes_relax_only_after_an_exact_baseline():
    """The router's decisions on injected EMAs, step by step, in both
    packages."""
    decisions = []
    for port in (False, True):
        side = _Side(port)
        eng = side.engine
        eng.relax_force = False
        eng.relax_min_workloads = 10
        seq = [eng._pick_relax_arm(50)]
        eng._arm_ema[("lean", "single")] = 1e-4
        seq += [eng._pick_relax_arm(50), eng._pick_relax_arm(5)]
        eng._arm_ema[("lean", "relax")] = 2e-4
        seq.append(eng._pick_relax_arm(50))
        seq.append(eng._arm_ema[("lean", "relax")])
        eng._arm_ema[("lean", "relax")] = 5e-5
        seq.append(eng._pick_relax_arm(50))
        eng.relax_enabled = False
        seq.append(eng._pick_relax_arm(50))
        decisions.append(seq)
    assert decisions[0] == decisions[1]
    assert decisions[1][:4] == [False, True, False, False]
    assert decisions[1][4] < 2e-4 and decisions[1][5] is True


def test_arm_wall_discards_each_arms_first_sample():
    _, p = _both()
    eng = p.engine
    eng._note_arm_wall("lean", "relax", 1.0, 10)
    assert ("lean", "relax") not in eng._arm_ema
    eng._note_arm_wall("lean", "relax", 1.0, 10)
    eng._note_arm_wall("lean", "relax", 2.0, 10)
    assert eng._arm_ema[("lean", "relax")] == pytest.approx(
        0.7 * 0.1 + 0.3 * 0.2)


def test_router_routes_a_churn_through_the_arm_like_jax():
    """No relax_force: two exact drains build the exact baseline (the
    first sample is discarded), then the arm probes on the third and the
    fourth drain (its own first sample is discarded too); every relaxed
    drain is audited. Four drains stay clear of the wall-clock
    comparison, so both packages route alike."""
    out = []
    for port in (False, True):
        side = _Side(port, relax_force=False, relax_min_workloads=16,
                     relax_audit_every=1)
        arms, keys = [], []
        for c in range(4):
            if c:
                side.finish_some(8, now=float(c))
            r = side.engine.drain(now=float(c), verify=True)
            arms.append(side.engine.last_relax_audit)
            keys.append(r.admitted_keys)
        out.append((arms, keys, side.counts.take(), side.parked()))
    assert out[0] == out[1]
    assert out[1][0] == [None, None, True, True]


# ---------------------------------------------------------------------------
# Scheduler(solver_config=...), the operator switches
# ---------------------------------------------------------------------------


RELAX_KNOBS = dict(relax_enabled=False, relax_min_workloads=77,
                   relax_audit_every=3, relax_iters=30,
                   relax_support_threshold=0.4,
                   relax_retry_cooldown_seconds=12.5)


def _engine_knobs(eng):
    return {"relax_enabled": eng.relax_enabled,
            "relax_min_workloads": eng.relax_min_workloads,
            "relax_audit_every": eng.relax_audit_every,
            "relax_iters": eng.relax_iters,
            "relax_support_threshold": eng.relax_support_threshold,
            "relax_retry_cooldown_seconds": eng.relax_retry_cooldown_s}


def test_scheduler_solver_config_wires_the_relaxed_arm_like_jax():
    jstore, pstore = _pair()
    jsched = JaxScheduler(jstore, JaxQueues(jstore), solver="auto",
                          solver_config=JaxSolverConfig(**RELAX_KNOBS))
    psched = PortScheduler(pstore, PortQueues(pstore), solver="auto",
                           device="cpu",
                           solver_config=SolverBackendConfig(**RELAX_KNOBS))
    jeng, peng = jsched._solver_engine(), psched._solver_engine()
    assert _engine_knobs(peng) == _engine_knobs(jeng) == RELAX_KNOBS
    defaults = _engine_knobs(PortScheduler(
        pstore, PortQueues(pstore), solver="auto", device="cpu",
        solver_config=SolverBackendConfig())._solver_engine())
    assert defaults == _engine_knobs(JaxEngine(
        jstore, JaxQueues(jstore), mesh_mode="off"))
    off = PortScheduler(pstore, PortQueues(pstore), solver="auto",
                        device="cpu", solver_config=SolverBackendConfig(
                            sessions_enabled=False))._solver_engine()
    assert off.use_sessions is False


def test_scheduler_solver_config_drives_the_arm():
    """A scheduler whose config forces a tiny relax floor: its drains
    run the relaxed arm (audited), as the JAX scheduler's do."""
    out = []
    for port in (False, True):
        types, store_cls = ((port_types, PortStore) if port
                            else (jax_types, JaxStore))
        store = _store(types, store_cls, n_cqs=4, n_wl=120, seed=9)
        cfg = dict(relax_min_workloads=8, relax_audit_every=1)
        if port:
            sched = PortScheduler(store, PortQueues(store), solver="auto",
                                  device="cpu", solver_min_backlog=0,
                                  solver_config=SolverBackendConfig(**cfg))
            eng = sched._solver_engine()
        else:
            queues = JaxQueues(store)
            sched = JaxScheduler(store, queues, solver_min_backlog=0,
                                 solver_config=JaxSolverConfig(**cfg))
            eng = JaxEngine(store, queues, scheduler=sched,
                            mesh_mode="off")
            eng.relax_min_workloads, eng.relax_audit_every = 8, 1
            sched.solver = eng
        counts = RelaxCounts(PORT if port else JAX, eng)
        audits = []
        for c in range(4):
            keys = [k for k, w in store.workloads.items()
                    if w.is_quota_reserved and not w.is_finished][:6]
            for k in keys:
                sched.finish_workload(k, now=float(c))
            eng.drain(now=float(c), verify=True)
            audits.append(eng.last_relax_audit)
        out.append((audits, counts.take()))
    assert out[0] == out[1]
    assert out[1][1]["audit_match"] + out[1][1]["audit_diverged"] == 2


@pytest.mark.parametrize("field,value,item", [
    ("socket_path", "/tmp/solver.sock", "8"),
    ("breaker_failure_threshold", 9, "8"),
    ("max_sessions", 2, "8"), ("mesh", "4", "9a"),
    ("coordinator_address", "h:1", "9b"),
    ("coordinator_processes", 2, "9b")])
def test_solver_config_refuses_sidecar_and_mesh_fields(field, value, item):
    # the sidecar's fields (item 8) and the single-process mesh mode
    # (item 9a) are ported now and accepted; the pod-scale coordinator's
    # (item 9b) are still refused
    if item in ("8", "9a"):
        assert getattr(SolverBackendConfig(**{field: value}),
                       field) == value
    else:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            SolverBackendConfig(**{field: value})
    assert SolverBackendConfig(mesh="off").mesh == "off"


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_sessions_env_switch_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("KUEUE_SOLVER_SESSIONS", raising=False)
    else:
        monkeypatch.setenv("KUEUE_SOLVER_SESSIONS", value)
    jstore, pstore = _pair()
    jeng = JaxEngine(jstore, JaxQueues(jstore), mesh_mode="off")
    peng = PortEngine(pstore, PortQueues(pstore), device="cpu")
    assert peng.use_sessions == jeng.use_sessions == (value != "0")


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_columnar_env_switch_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("KUEUE_COLUMNAR_EXPORT", raising=False)
    else:
        monkeypatch.setenv("KUEUE_COLUMNAR_EXPORT", value)
    jstore, pstore = _pair()
    jeng = JaxEngine(jstore, JaxQueues(jstore), mesh_mode="off")
    peng = PortEngine(pstore, PortQueues(pstore), device="cpu")
    has = peng.export_cache.columnar is not None
    assert has == (jeng.export_cache.columnar is not None) == (value != "0")
    # the export is the same with the view on or off
    jp, _ = jeng.export()
    pp, _ = peng.export()
    assert np.array_equal(pp.wl_req, jp.wl_req)
    assert pp.wl_keys == list(jp.wl_keys)


# ---------------------------------------------------------------------------
# phase 18's runs at cut sizes, and the relax tier per scenario
# ---------------------------------------------------------------------------


def test_relax_arm_record_matches_jax_on_a_cut_large_scale_store():
    recs = []
    for root in (JAX, PORT):
        problem, padded = large_scale_problems(root, n_cohorts=2,
                                               cqs_per_cohort=5)
        rec, _ = relax_arm_record(root, padded, exact_plan(root, problem))
        recs.append(rec)
    assert recs[0] == recs[1]
    assert recs[1]["live"] == 500


@pytest.mark.parametrize("audit_every,served", [(1, 0), (3, 1)])
def test_churn_record_matches_jax_on_a_cut_small_shape(audit_every, served):
    (jrec, _), (prec, results) = (
        churn_record(root, n_cycles=2, n_cohorts=2, cqs_per_cohort=4,
                     audit_every=audit_every) for root in (JAX, PORT))
    assert prec == jrec
    assert prec["oracle_rejections"] == 0 and prec["drains"] == 3
    assert prec["served"] == served
    assert prec["audit_match"] + prec["audit_diverged"] == 3 - served
    if served:
        # the served drain 2 kept the exact arm's resident state current
        # with its frame, and the audited drain 3 solved on that state
        dev = results[1].device
        assert dev["delta_updates"] + dev["donated_full_syncs"] == 1
        assert results[2].device["full_uploads"] == 0


def test_solve_scenarios_relax_matches_jax_per_scenario():
    (jrec, jout), (prec, pout) = (relax_tier_record(root, n_scenarios=6)
                                  for root in (JAX, PORT))
    assert prec == jrec
    assert pout.tier == jout.tier == ["relax"] * 6
    for name in ("admitted", "opt", "admit_round", "parked", "rounds",
                 "usage"):
        a, b = getattr(pout, name), np.asarray(getattr(jout, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for i in range(6):
        assert _plans_equal(pout.plan(i), jout.plan(i))
