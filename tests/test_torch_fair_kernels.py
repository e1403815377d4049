"""The port's fair-sharing kernels against the JAX package's, function by
function, on the CPU with tolerance 0 (integers and float32 bitwise).

The problems have the shapes of tests/test_fair_parity.py's
``build_fs_scenario`` (``fs_store`` of tests/test_torch_engine_fair.py:
fair weights drawn from {0, 0.5, 1, 2}, one cohort or a two-level
cohort tree, and a parentless ClusterQueue): the JAX host scheduler
admits the first phase under fair sharing, the second phase arrives,
and the JAX export of that store is carried into the port through
``convert.full_tensors_from_arrays``, so both sides see identical
tensors. Each function is compared on every round state the port's fair
drain passes through: ``lendable_by_resource``, ``drs_all`` (on the
round usage, a perturbed usage and a lane batch), the fair search of
every (head, option) lane (victims, reasons and borrow-after levels
included) and ``fair_entry_pick`` under the round's active entries and
seeded random subsets of them. The four ``drs_*`` comparisons and the
two primitives the kernels added to ``ops`` (float segment minima and
maxima, the per-resource FR sum) are compared on seeded numpy inputs.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine_fair import fs_store

from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager
from kueue_oss_tpu.core.store import Store
from kueue_oss_tpu.scheduler.scheduler import Scheduler
from kueue_oss_tpu.solver import fair_kernels as jfair
from kueue_oss_tpu.solver import full_kernels as jfk
from kueue_oss_tpu.solver.kernels import available_all as jax_avail
from kueue_oss_tpu.solver.kernels import (
    potential_available_all as jax_pot,
)
from kueue_oss_tpu.solver.tensors import export_problem, pad_workloads
from kueue_oss_tpu_torch.convert import full_tensors_from_arrays
from kueue_oss_tpu_torch.solver import fair_kernels as pfair
from kueue_oss_tpu_torch.solver import full_kernels as pfk
from kueue_oss_tpu_torch.solver import ops
from kueue_oss_tpu_torch.solver.kernels import (
    potential_available_all as port_pot,
)
from kueue_oss_tpu_torch.solver.tensors import POLICY_ANY

#: name -> (fs_store seed, uniform): one cohort over cpu and memory; a
#: two-level tree; a two-level tree of equal quotas and weights, where
#: shares tie
PROBLEMS = {"one_cohort": (2, False), "two_level": (3, False),
            "uniform": (1, True)}
H_MAX, P_MAX, PAD_W = 8, 32, 64
#: random active-entry subsets per round state
N_MASKS = 6


def _export(seed, uniform):
    store, phase1, phase2 = fs_store(jax_types, Store, seed, uniform)
    queues = QueueManager(store)
    sched = Scheduler(store, queues, enable_fair_sharing=True)
    for wl in phase1:
        store.add_workload(wl)
    sched.run_until_quiet(now=50.0, tick=1.0)
    for wl in phase2:
        store.add_workload(wl)
    pending, parked = {}, {}
    for name, q in queues.queues.items():
        if q.snapshot_order():
            pending[name] = q.snapshot_order()
        if q.inadmissible:
            parked[name] = list(q.inadmissible.values())
    problem = export_problem(store, pending, include_admitted=True,
                             parked=parked)
    return pad_workloads(problem, PAD_W)


def _components(t, st, pot, lend, usage2, usage3, masks, g_max):
    """The JAX intermediates of one round state: heads, nomination,
    lendable, DRS, the fair search of every (workload row, option) lane
    under the round usage and ``usage2``, and the entry pick under each
    mask and usage."""
    W_null = t.wl_cqid.shape[0] - 1
    C, K = t.cq_opt_group.shape
    parked = st["parked"] | (~st["admitted"] & st["class_nofit"][t.wl_class])
    parked = parked.at[-1].set(False)
    cand_w = jfk.select_heads_full(t, st["admitted"], parked, st["ts"],
                                   lq_penalty=st["lq_penalty"])
    avail = jax_avail(t, st["usage"])
    nom = jfk.nominate_full(t, st["usage"], avail, pot, cand_w,
                            st["cursor"], g_max, True)
    table = jfk.build_candidate_table(t, st["admitted"], st["admit_rank"],
                                      st["wl_usage"], P_MAX)
    # one lane per (workload row, option): every row as a preemptor
    W1 = t.wl_cqid.shape[0]
    rows = jnp.arange(W1, dtype=jnp.int32)
    cqi = jnp.minimum(t.wl_cqid, C - 1)
    lanes = (jnp.repeat(rows, K), t.wl_req.reshape(W1 * K, -1),
             jnp.repeat(avail[t.cq_node[cqi]], K, axis=0),
             jnp.repeat(table[t.cq_root[cqi]], K, axis=0))

    def search(usage):
        return jax.vmap(lambda a, b, c, d: jfair.fair_search(
            t, lend, usage, st["wl_usage"], st["admitted"], st["evicted"],
            st["ts"], a, b, c, d, P_MAX))(*lanes)

    active = (cand_w != W_null) & (nom[0] != jfk.M_NOFIT)
    all_masks = jnp.concatenate([active[None], masks & active[None]])
    picks = jax.vmap(lambda u, m: jfair.fair_entry_pick(
        t, lend, u, cand_w, nom[2], st["ts"], m), in_axes=(None, 0))
    return dict(
        cand_w=cand_w, nom=nom, lanes=lanes, search=search(st["usage"]),
        search2=search(usage2),
        lend=jfair.lendable_by_resource(t, pot),
        drs=jfair.drs_all(t, st["usage"], lend),
        drs2=jfair.drs_all(t, usage2, lend),
        drs3=jfair.drs_all(t, usage3, lend),
        masks=all_masks, picks=picks(st["usage"], all_masks),
        picks2=picks(usage2, all_masks), picks3=picks(usage3, all_masks))


class Problem:
    """Both packages' tensors of one problem, the round states of the
    port's fair drain, and the JAX intermediates of each (one compiled
    JAX program per problem)."""

    def __init__(self, name):
        seed, uniform = PROBLEMS[name]
        self.problem = _export(seed, uniform)
        host = jfk.host_tensors_full(self.problem)
        self.jt = jax.tree_util.tree_map(jnp.asarray, host)
        self.pt = full_tensors_from_arrays(host, "cpu")
        self.g_max = int(self.problem.cq_ngroups.max())
        self.ppot = port_pot(self.pt)
        self.plend = pfair.lendable_by_resource(self.pt, self.ppot)
        state = pfk._init_state(self.pt, self.g_max)
        self.states = [state]
        while len(self.states) < 40 and bool(state["progress"]):
            state, _ = pfk.round_body(self.pt, state, self.ppot, self.g_max,
                                      H_MAX, P_MAX, pfk.FullDrainStats(),
                                      True, self.plend)
            self.states.append(state)
        rng = np.random.default_rng(seed)
        C = self.problem.n_cqs
        shape = tuple(self.pt.usage0.shape)
        # near the round usage, and wide (many distinct share ratios)
        self.usage2 = [st["usage"] + torch.from_numpy(
            rng.integers(0, 8, size=shape).astype(np.int32))
            for st in self.states]
        self.usage3 = [torch.from_numpy(
            rng.integers(0, 400, size=shape).astype(np.int32))
            for _ in self.states]
        self.masks = [rng.random((N_MASKS, C)) < 0.5 for _ in self.states]
        jpot = jax_pot(self.jt)
        jlend = jfair.lendable_by_resource(self.jt, jpot)
        g = self.g_max
        components = jax.jit(
            lambda t, st, pot, lend, u2, u3, m: _components(
                t, st, pot, lend, u2, u3, m, g))
        self.want = [components(self.jt, self._jax_state(st), jpot, jlend,
                                jnp.asarray(u2.numpy()),
                                jnp.asarray(u3.numpy()), jnp.asarray(m))
                     for st, u2, u3, m in zip(self.states, self.usage2,
                                              self.usage3, self.masks)]

    def _jax_state(self, st):
        out = {k: jnp.asarray(v.numpy()) for k, v in st.items()
               if k != "rounds"}
        out["rounds"] = jnp.int32(st["rounds"])
        return out


_PROBLEMS: dict = {}


def _problem(name):
    if name not in _PROBLEMS:
        _PROBLEMS[name] = Problem(name)
    return _PROBLEMS[name]


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def prob(request):
    return _problem(request.param)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _t(x):
    """A JAX array as a torch tensor with the same dtype."""
    return torch.from_numpy(np.array(x))


def test_lendable_and_drs_all(prob):
    pt = prob.pt
    _same(prob.plend, prob.want[0]["lend"], "lendable_by_resource")
    names = ("zwb", "share", "borrowing", "unweighted")
    for st, u2, u3, want in zip(prob.states, prob.usage2, prob.usage3,
                                prob.want):
        for usage, key in ((st["usage"], "drs"), (u2, "drs2"),
                           (u3, "drs3")):
            got = pfair.drs_all(pt, usage, prob.plend)
            for name, g, w in zip(names, got, want[key]):
                _same(g, w, f"drs_all {name}")
        # a lane batch: each lane's row equals the unbatched result
        batch = pfair.drs_all(pt, torch.stack([st["usage"], u2]), prob.plend)
        for name, g, w1, w2 in zip(names, batch, want["drs"], want["drs2"]):
            _same(g[0], w1, f"drs_all batch {name}")
            _same(g[1], w2, f"drs_all batch {name}")
    shares = np.concatenate([_np(w["drs2"][1]) for w in prob.want])
    assert (shares > 0).any(), "vacuous: nothing borrows"


def test_drs_comparisons():
    rng = np.random.default_rng(7)
    n = 4096
    vals = np.asarray([0.0, 0.5, 1.0, 1.5, 250.0, np.inf], dtype=np.float32)
    args = []
    for _ in range(2):
        args += [rng.random(n) < 0.3, vals[rng.integers(0, len(vals), n)],
                 vals[rng.integers(0, len(vals), n)]]
    for name in ("drs_gt", "drs_ge", "drs_le", "drs_lt"):
        got = getattr(pfair, name)(*(torch.from_numpy(a) for a in args))
        want = getattr(jfair, name)(*(jnp.asarray(a) for a in args))
        _same(got, want, name)


def test_fair_search_every_lane_output(prob):
    names = ("success", "cand_w", "victims", "victim_reason",
             "any_same_cq", "borrow_after")
    for st, u2, want in zip(prob.states, prob.usage2, prob.want):
        for usage, key in ((st["usage"], "search"), (u2, "search2")):
            got = pfair.fair_search(
                prob.pt, prob.plend, usage, st["wl_usage"],
                st["admitted"], st["evicted"], st["ts"],
                *(_t(a) for a in want["lanes"]), P_MAX,
                pfk.FullDrainStats())
            for name, g, w in zip(names, got, want[key]):
                _same(g, w, f"{key} {name}")


def test_fair_search_reaches_every_victim_kind():
    """Across the problems some lane preempts within its ClusterQueue
    (a pending workload of the parentless one included), some as a
    within-nominal preemptor (InCohortReclamation) and some by the
    strategy rules (InCohortFairSharing); some node has weight 0."""
    reasons = set()
    solo_victims = 0
    for name in PROBLEMS:
        prob = _problem(name)
        solo = prob.problem.cq_names.index("solo")
        for want in prob.want:
            r = _np(want["search"][3])
            reasons |= set(np.unique(r[r > 0]).tolist())
            heads = _np(want["lanes"][0])
            pending = ~prob.problem.wl_admitted0[heads]
            lane_cq = prob.problem.wl_cqid[heads]
            solo_victims += int(_np(want["search"][2])[
                pending & (lane_cq == solo)].sum())
    assert {pfk.V_WITHIN_CQ, pfk.V_HIERARCHICAL_RECLAIM,
            pfair.V_FAIR_SHARING} <= reasons, reasons
    assert solo_victims > 0
    assert min(_problem(n).problem.node_fair_weight.min()
               for n in PROBLEMS) == 0.0, "no zero-weight node"


def test_fair_entry_pick(prob):
    pt = prob.pt
    picked = set()
    for st, u2, u3, want in zip(prob.states, prob.usage2, prob.usage3,
                                prob.want):
        cand_w = _t(want["cand_w"])
        req_c = _t(want["nom"][2])
        for key, usage in (("picks", st["usage"]), ("picks2", u2),
                           ("picks3", u3)):
            for i, mask in enumerate(_np(want["masks"])):
                got = pfair.fair_entry_pick(pt, prob.plend, usage, cand_w,
                                            req_c, st["ts"],
                                            torch.from_numpy(mask.copy()))
                _same(got, want[key][i], f"fair_entry_pick {key}[{i}]")
                picked.add(int(got))
    assert len(picked) > 2, picked


def test_ops_float_segments_and_resource_sum():
    rng = np.random.default_rng(11)
    data = rng.standard_normal(50).astype(np.float32)
    seg = rng.integers(0, 12, 50).astype(np.int32)  # segments 12-15 empty
    for pname, jfn in (("segment_min", jax.ops.segment_min),
                       ("segment_max", jax.ops.segment_max)):
        got = getattr(ops, pname)(torch.from_numpy(data),
                                  torch.from_numpy(seg), 16)
        _same(got, jfn(jnp.asarray(data), jnp.asarray(seg),
                       num_segments=16), pname)
    fr_resource = rng.integers(0, 3, 7).astype(np.int32)
    onehot = np.eye(3, dtype=np.int32)[fr_resource]
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(4, 5, 7), dtype=np.int64)
    x = x.astype(np.int32)  # wide values: the sums wrap in int32
    got = ops.resource_sum(torch.from_numpy(x), torch.from_numpy(fr_resource),
                           3)
    _same(got, jnp.asarray(x) @ jnp.asarray(onehot), "resource_sum")


#: seeded random draws per problem for the random-input tests
N_DRAWS, DRAW_LANES, PICK_DRAWS = 48, 4, 160


def _random_search_inputs(prob, rng):
    """Random round states and lanes over the problem's tree: usage
    (half the draws independent per node, half with about 70% of the
    nodes borrowing one same amount, so that shares tie), admitted /
    evicted sets,
    timestamps with ties, heads, requests, availability and candidate
    rows (W_null padded)."""
    t = prob.problem
    W1 = t.wl_cqid.shape[0]
    real = np.nonzero(t.wl_cqid[:-1] < t.n_cqs)[0]   # unpadded rows
    N1, F = t.usage0.shape
    half = N_DRAWS // 2
    usage = np.concatenate([
        rng.integers(0, 30, (half, N1, F)),
        t.subtree[None] + rng.integers(1, 4, (N_DRAWS - half, 1, 1))
        * (rng.random((N_DRAWS - half, N1, 1)) < 0.7)])
    state = dict(
        usage=usage,
        wl_usage=np.broadcast_to(t.wl_req[:, 0, :], (N_DRAWS, W1, F)),
        admitted=rng.random((N_DRAWS, W1)) < 0.6,
        evicted=rng.random((N_DRAWS, W1)) < 0.2,
        ts=rng.integers(0, 4, (N_DRAWS, W1)))
    state["admitted"][:, -1] = False
    lanes = dict(
        head=rng.choice(real, (N_DRAWS, DRAW_LANES)),
        req=rng.integers(0, 6, (N_DRAWS, DRAW_LANES, F)),
        avail=rng.integers(-2, 8, (N_DRAWS, DRAW_LANES, F)),
        cands=np.where(rng.random((N_DRAWS, DRAW_LANES, P_MAX)) < 0.8,
                       rng.choice(real, (N_DRAWS, DRAW_LANES, P_MAX)),
                       W1 - 1))
    cast = {"admitted": np.bool_, "evicted": np.bool_}
    return ({k: np.ascontiguousarray(v, dtype=cast.get(k, np.int32))
             for k, v in state.items()},
            {k: v.astype(np.int32) for k, v in lanes.items()})


def test_fair_search_random_inputs(prob):
    """Random round states exercise the tournament's ties (equal shares
    of CQs and cohorts side by side), zero weights, two resources and
    both strategy phases; every ClusterQueue preempts with policy Any
    here, so that candidates are legal."""
    rng = np.random.default_rng(101)
    state, lanes = _random_search_inputs(prob, rng)
    C = prob.problem.n_cqs
    anyp = np.full(C, POLICY_ANY, dtype=np.int32)
    jt = prob.jt._replace(cq_within_policy=jnp.asarray(anyp),
                          cq_reclaim_policy=jnp.asarray(anyp))
    pt = prob.pt._replace(cq_within_policy=torch.from_numpy(anyp),
                          cq_reclaim_policy=torch.from_numpy(anyp))
    jlend = jfair.lendable_by_resource(jt, jax_pot(jt))

    def one(u, wu, adm, ev, ts, hw, rq, av, cd):
        return jax.vmap(lambda a, b, c, d: jfair.fair_search(
            jt, jlend, u, wu, adm, ev, ts, a, b, c, d, P_MAX))(
                hw, rq, av, cd)

    want = jax.jit(jax.vmap(one))(
        *(jnp.asarray(state[k]) for k in ("usage", "wl_usage", "admitted",
                                          "evicted", "ts")),
        *(jnp.asarray(lanes[k]) for k in ("head", "req", "avail", "cands")))
    names = ("success", "cand_w", "victims", "victim_reason",
             "any_same_cq", "borrow_after")
    for i in range(N_DRAWS):
        got = pfair.fair_search(
            pt, prob.plend,
            *(torch.from_numpy(state[k][i]) for k in (
                "usage", "wl_usage", "admitted", "evicted", "ts")),
            *(torch.from_numpy(lanes[k][i]) for k in (
                "head", "req", "avail", "cands")),
            P_MAX, pfk.FullDrainStats())
        for name, g, w in zip(names, got, want):
            _same(g, w[i], f"fair_search draw {i} {name}")
    assert np.asarray(want[2]).any()


def test_fair_entry_pick_random_inputs(prob):
    """Random heads, requests (zeros included), usage and timestamps
    with ties: every key of the tournament decides some pick."""
    rng = np.random.default_rng(202)
    t = prob.problem
    W1 = t.wl_cqid.shape[0]
    N1, F = t.usage0.shape
    C = t.n_cqs
    usage = rng.integers(0, 30, (PICK_DRAWS, N1, F)).astype(np.int32)
    cand_w = rng.integers(0, W1, (PICK_DRAWS, C)).astype(np.int32)
    req_c = rng.integers(0, 4, (PICK_DRAWS, C, F)).astype(np.int32)
    ts = rng.integers(0, 3, (PICK_DRAWS, W1)).astype(np.int32)
    active = rng.random((PICK_DRAWS, C)) < 0.7
    jlend = jfair.lendable_by_resource(prob.jt, jax_pot(prob.jt))
    want = np.asarray(jax.jit(jax.vmap(
        lambda u, cw, rq, s, a: jfair.fair_entry_pick(
            prob.jt, jlend, u, cw, rq, s, a)))(
        jnp.asarray(usage), jnp.asarray(cand_w), jnp.asarray(req_c),
        jnp.asarray(ts), jnp.asarray(active)))
    for i in range(PICK_DRAWS):
        got = pfair.fair_entry_pick(
            prob.pt, prob.plend, torch.from_numpy(usage[i]),
            torch.from_numpy(cand_w[i]), torch.from_numpy(req_c[i]),
            torch.from_numpy(ts[i]), torch.from_numpy(active[i]))
        _same(got, want[i], f"fair_entry_pick draw {i}")
    assert len(set(want.tolist())) > 2
