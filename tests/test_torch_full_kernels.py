"""The port's FULL drain kernels against the JAX package's, function by
function, on the CPU with tolerance 0.

The problems come from the JAX package's own randomized preemption
scenarios (tests/test_full_kernel_parity.py ``build_scenario`` and the
deep multi-resource-group shapes of
tests/test_full_kernel_parity_hard.py): the host scheduler admits a
first phase, a second phase arrives, and the JAX export of that store
is carried into the port through ``convert.full_tensors_from_arrays``,
so both sides see identical tensors. Each function is compared on the
round states the JAX drain passes through: head selection, nomination,
the candidate table, the victim search of every (head, option) lane
(victims, their reasons and the borrow-after levels included), the
flavor walk, the entry scan, one whole round, and the whole drain. The
``overflow`` problem runs with two lanes and eight candidate slots, so
that preempt-needing heads exceed ``h_max`` and a root's candidates
exceed ``p_max``, and the dropped writes are exercised.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_kernel_parity as scen
import test_full_kernel_parity_hard as hard
from kueue_oss_tpu.core.queue_manager import QueueManager
from kueue_oss_tpu.scheduler.scheduler import Scheduler
from kueue_oss_tpu.solver import full_kernels as jfk
from kueue_oss_tpu.solver.kernels import available_all as jax_avail
from kueue_oss_tpu.solver.kernels import (
    potential_available_all as jax_pot,
)
from kueue_oss_tpu.solver.tensors import export_problem, pad_workloads
from kueue_oss_tpu_torch.convert import full_tensors_from_arrays
from kueue_oss_tpu_torch.solver import full_kernels as pfk
from kueue_oss_tpu_torch.solver.kernels import available_all as port_avail
from kueue_oss_tpu_torch.solver.kernels import (
    potential_available_all as port_pot,
)

#: name -> (builder, workload maker, seed, h_max, p_max); one padded
#: workload axis per problem, caps fixed per problem
PROBLEMS = {
    "scenario": (scen.build_scenario, scen._mk_wl, 3, 8, 32),
    "overflow": (hard.build_hard_scenario, hard._mk_wl, 5, 2, 8),
}
PAD_W = 128


def _export(build, mk_wl, seed):
    store, phase1, phase2 = build(seed)
    queues = QueueManager(store)
    sched = Scheduler(store, queues)
    uid = 1
    for spec in phase1:
        store.add_workload(mk_wl(spec, uid))
        uid += 1
    sched.run_until_quiet(now=50.0, tick=1.0)
    for spec in phase2:
        store.add_workload(mk_wl(spec, uid))
        uid += 1
    pending, parked = {}, {}
    for name, q in queues.queues.items():
        if q.snapshot_order():
            pending[name] = q.snapshot_order()
        if q.inadmissible:
            parked[name] = list(q.inadmissible.values())
    problem = export_problem(store, pending, include_admitted=True,
                             parked=parked)
    return pad_workloads(problem, PAD_W)


def _components(t, st, pot, g_max, h_max, p_max):
    """Every JAX intermediate of one round state that the tests compare:
    heads, availability, nomination, the candidate table, the search of
    every (head, option) lane, the flavor walk of every head, the entry
    scan with one lane per head (its first option's search, the lanes
    left uncompacted), and the whole round."""
    W_null = t.wl_cqid.shape[0] - 1
    C, K = t.cq_opt_group.shape
    parked = st["parked"] | (~st["admitted"] & st["class_nofit"][t.wl_class])
    parked = parked.at[-1].set(False)
    cand_w = jfk.select_heads_full(t, st["admitted"], parked, st["ts"])
    avail = jax_avail(t, st["usage"])
    nom = jfk.nominate_full(t, st["usage"], avail, pot, cand_w,
                            st["cursor"], g_max)
    (mode, _k, _req, _b, _nc, opt_fit, opt_preempt, opt_level,
     group_active, opt_valid) = nom
    table = jfk.build_candidate_table(t, st["admitted"], st["admit_rank"],
                                      st["wl_usage"], p_max)
    lanes = (jnp.repeat(cand_w, K),
             t.wl_req[cand_w].reshape(C * K, -1),
             jnp.repeat(avail[t.cq_node], K, axis=0),
             jnp.repeat(table[t.cq_root], K, axis=0))
    search = jax.vmap(lambda a, b, c, d: jfk.classical_search(
        t, st["usage"], st["wl_usage"], st["admitted"], st["evicted"],
        st["ts"], a, b, c, d, p_max))(*lanes)
    s_succ, s_cw, s_vic, s_reason, s_same, s_borrow = search
    sim = jnp.where(s_succ, jnp.where(s_same, jfk.P_PREEMPT, jfk.P_RECLAIM),
                    jfk.P_NO_CANDIDATES).reshape(C, K)
    pre = opt_preempt & ~opt_fit
    pmode_k = jnp.where(opt_fit, jfk.P_FIT, jnp.where(pre, sim, jfk.P_NOFIT))
    borrow_k = jnp.where(opt_fit, opt_level,
                         jnp.where(pre, s_borrow.reshape(C, K), 0))
    walk_in = (cand_w, pmode_k, borrow_k, opt_valid, group_active)
    walk = jax.vmap(lambda a, b, c, d, e: jfk.walk_assign(
        t, a, b, c, d, e, g_max))(*walk_in)
    idx = jnp.arange(C) * K
    scan_lanes = (jnp.where(cand_w != W_null, jnp.arange(C), -1).astype(
        jnp.int32), s_succ[idx] & (walk[0] == jfk.M_PREEMPT), s_cw[idx],
        s_vic[idx], s_reason[idx])
    scan_state = {
        "usage_full": st["usage"], "usage_net": st["usage"],
        "cq_rows": st["cq_rows"], "admitted": st["admitted"],
        "parked": parked, "wl_usage": st["wl_usage"],
        "victims_all": jnp.zeros_like(st["admitted"]),
        "victim_reason": st["victim_reason"], "ts": st["ts"],
        "lq_penalty": t.lq_penalty0}
    scan = jfk.full_round_scan(t, scan_state, cand_w, *walk[:4],
                               *scan_lanes, p_max)
    new_state, _ = jfk.round_body(t, st, pot, g_max, h_max, p_max)
    return dict(parked=parked, cand_w=cand_w, avail=avail, nom=nom,
                table=table, lanes=lanes, search=search, walk_in=walk_in,
                walk=walk, scan_state=scan_state, scan_lanes=scan_lanes,
                scan=scan, round=new_state)


class Problem:
    """Both packages' tensors of one problem, its caps, the round states
    the port's drain passes through, and the JAX intermediates of each
    (one compiled JAX program per problem)."""

    def __init__(self, name):
        build, mk_wl, seed, self.h_max, self.p_max = PROBLEMS[name]
        self.problem = _export(build, mk_wl, seed)
        host = jfk.host_tensors_full(self.problem)
        self.jt = jax.tree_util.tree_map(jnp.asarray, host)
        self.pt = full_tensors_from_arrays(host, "cpu")
        self.g_max = int(self.problem.cq_ngroups.max())
        self.ppot = port_pot(self.pt)
        g, h, p = self.g_max, self.h_max, self.p_max
        state = pfk._init_state(self.pt, g)
        self.states = [state]
        while len(self.states) < 40 and bool(state["progress"]):
            state, _ = pfk.round_body(self.pt, state, self.ppot, g, h, p,
                                      pfk.FullDrainStats())
            self.states.append(state)
        components = jax.jit(
            lambda t, st, pot: _components(t, st, pot, g, h, p))
        jpot = jax_pot(self.jt)
        self.want = [components(self.jt, self._jax_state(st), jpot)
                     for st in self.states]

    def _jax_state(self, st):
        out = {k: jnp.asarray(v.numpy()) for k, v in st.items()
               if k != "rounds"}
        out["rounds"] = jnp.int32(st["rounds"])
        out["lq_penalty"] = self.jt.lq_penalty0
        return out


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def prob(request):
    return Problem(request.param)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _t(x):
    """A JAX array as a torch tensor with the same dtype."""
    return torch.from_numpy(np.array(x))


def test_head_selection_nomination_and_candidate_table(prob):
    pt = prob.pt
    for st, want in zip(prob.states, prob.want):
        got_w = pfk.select_heads_full(pt, st["admitted"],
                                      _t(want["parked"]), st["ts"])
        _same(got_w, want["cand_w"], "select_heads_full")
        avail = port_avail(pt, st["usage"])
        _same(avail, want["avail"], "available_all")
        got = pfk.nominate_full(pt, st["usage"], avail, prob.ppot, got_w,
                                st["cursor"], prob.g_max)
        for i, (g, w) in enumerate(zip(got, want["nom"])):
            _same(g, w, f"nominate_full[{i}]")
        got_table = pfk.build_candidate_table(
            pt, st["admitted"], st["admit_rank"], st["wl_usage"],
            prob.p_max)
        _same(got_table, want["table"], "build_candidate_table")


def test_classical_search_every_lane_output(prob):
    searched = 0
    for st, want in zip(prob.states, prob.want):
        got = pfk.classical_search(
            prob.pt, st["usage"], st["wl_usage"], st["admitted"],
            st["evicted"], st["ts"], *(_t(a) for a in want["lanes"]),
            prob.p_max, pfk.FullDrainStats())
        names = ("success", "cand_w", "victims", "victim_reason",
                 "any_same_cq", "borrow_after")
        for name, g, w in zip(names, got, want["search"]):
            _same(g, w, f"classical_search {name}")
        searched += int(np.asarray(want["search"][2]).sum())
    assert searched > 0, "vacuous: no lane found victims"


def test_walk_assign_and_entry_scan(prob):
    for st, want in zip(prob.states, prob.want):
        got = pfk.walk_assign(prob.pt, *(_t(a) for a in want["walk_in"]),
                              prob.g_max)
        for i, (g, w) in enumerate(zip(got, want["walk"])):
            _same(g, w, f"walk_assign[{i}]")
        p_state = {k: _t(v) for k, v in want["scan_state"].items()}
        g_out, *g_flags = pfk.full_round_scan(
            prob.pt, p_state, _t(want["cand_w"]),
            *(_t(a) for a in want["walk"][:4]),
            *(_t(a) for a in want["scan_lanes"]), prob.p_max,
            pfk.FullDrainStats())
        w_out, *w_flags = want["scan"]
        for k, g in g_out.items():
            _same(g, w_out[k], f"full_round_scan {k}")
        for i, (g, w) in enumerate(zip(g_flags, w_flags)):
            _same(g, w, f"full_round_scan flags[{i}]")


def test_round_body_and_null_row_writes(prob):
    """Every round of the drain against the JAX round; the scatters
    whose duplicate indices all address the null row must leave it as
    it was (every duplicate writes the null row's own value)."""
    for before, after, want in zip(prob.states, prob.states[1:],
                                   prob.want):
        for k, g in after.items():
            if k == "rounds":
                assert g == int(want["round"]["rounds"])
            else:
                _same(g, want["round"][k], f"round_body {k}")
        for k in ("ts", "evicted", "admit_rank", "opt", "admit_round",
                  "cursor", "parked"):
            _same(after[k][-1], before[k][-1], f"null row of {k}")


def test_whole_drain_and_caps(prob):
    stats = pfk.FullDrainStats()
    want = jfk.solve_backlog_full(prob.jt, g_max=prob.g_max,
                                  h_max=prob.h_max, p_max=prob.p_max)
    got = pfk.solve_backlog_full(prob.pt, g_max=prob.g_max,
                                 h_max=prob.h_max, p_max=prob.p_max,
                                 stats=stats)
    names = ("admitted", "opt", "admit_round", "parked", "rounds", "usage",
             "wl_usage", "victim_reason")
    for name, g, w in zip(names, got, want):
        _same(g, w, f"solve_backlog_full {name}")
    assert stats.rounds == int(want[4]) and stats.lanes > 0
    assert stats.syncs >= stats.rounds
    victims = (prob.problem.wl_admitted0 & ~_np(got[0])).sum()
    assert victims > 0, "vacuous: nothing preempted"
    if prob.h_max == 2:
        # the overflow problem must overflow both caps in some round
        over_h = over_p = False
        pt = prob.pt
        C = pt.cq_node.shape[0]
        roots = pt.cq_root[torch.clamp(pt.wl_cqid[:-1], max=C - 1)]
        for st, want in zip(prob.states, prob.want):
            mode, opt_fit, opt_preempt = (_t(want["nom"][i])
                                          for i in (0, 5, 6))
            fit_wins = ((mode == pfk.M_FIT) & pt.cq_preempt_try_next
                        & ~pt.cq_pref_pob)
            needs = ((_t(want["cand_w"]) != prob.problem.n_workloads)
                     & (opt_preempt & ~opt_fit).any(dim=1) & ~fit_wins
                     & (mode != pfk.M_NOFIT))
            over_h |= int(needs.sum()) > prob.h_max
            elig = st["admitted"][:-1] & (st["wl_usage"][:-1] > 0).any(dim=1)
            counts = torch.bincount(roots[elig].long())
            over_p |= bool(counts.numel()) and int(counts.max()) > prob.p_max
        assert over_h and over_p
