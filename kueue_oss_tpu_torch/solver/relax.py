"""Convex-relaxation fast path for the batched admission problem.

Port of ``kueue_oss_tpu/solver/relax.py``. The exact lean drain replays
priority-ordered rounds whose count grows with per-CQ backlog depth; the
relaxed arm instead:

1. **relaxes** the admission problem to an LP over a fractional admit
   vector x in [0, 1]^W (priority-weighted admission subject to one
   capacity row per (hierarchy node, flavor-resource)) and solves it by
   a fixed number of projected-gradient steps: ``lp_loop``, in plain
   PyTorch here (the CPU path and the oracle), and in one launch of the
   hand-written ``csrc/relax_lp.cu`` on the card
   (``cuda_relax.relax_lp``);
2. **rounds** x on the host to a support (``rounded_support``): rows
   above the threshold, every live StrictFIFO row, and a per-CQ
   allowance by (-x, FIFO rank);
3. **repairs** the support with the EXACT lean drain
   (``kernels.solve_backlog`` on the compacted subproblem, on the
   caller's device), so the plan is always exactly feasible.

The projected-gradient step keeps the JAX program's float32 op order so
that x is bit for bit the JAX package's on the CPU: segment sums in
ascending row order (``index_add_`` on the CPU; the kernel's per-CQ row
lists), the ancestor accumulation adding each level into the old ``u``,
``rho`` as float32 ops in JAX's order, the sum over the path as adds in
index order, the sum over the flavor-resources in XLA:CPU's vectorised
order (``sum_order``), and a ``price`` gather that clamps
the padding id C to row C-1 as JAX's gather does. Cut from the copy: the
mesh-sharded LP (``meshutil.relax_mesh_lp``, ROADMAP Queue A item 9).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.tensors import SolverProblem, pow2

#: projected-gradient constants: step size, score (objective) weight,
#: and the quadratic-penalty ramp rho0 * (1 + growth * i / iters). The
#: LP only has to CONCENTRATE mass and ORDER candidates — the repair
#: pass is exact — so these favor robustness over last-digit optimality.
ETA = 0.5
ALPHA = 0.05
RHO0 = 1.0
RHO_GROWTH = 3.0

#: effectively-unbounded capacity for constraint rows that only bind at
#: an ancestor (non-root nodes without a borrowing limit)
UNBOUNDED = np.float32(1 << 30)


class RelaxLP(NamedTuple):
    """Inputs of the relaxed admission LP (numpy on the host, tensors on
    a device; ``lp_loop`` and the kernel take the tensor form)."""

    r: np.ndarray        # [W+1, F] float32 request, first valid option
    s: np.ndarray        # [W+1] float32 priority-major, FIFO-minor score
    live: np.ndarray     # [W+1] bool
    wl_cqid: np.ndarray  # [W+1] int32
    cq_node: np.ndarray  # [C] int32
    path_cq: np.ndarray  # [C, D] int32 ancestor chain of each CQ's node
    parent: np.ndarray   # [N+1] int32
    depth: np.ndarray    # [N+1] int32
    slack: np.ndarray    # [N+1, F] float32 aggregate headroom per node
    scale: np.ndarray    # [N+1, F] float32 max(slack, 1) normalizer


@dataclass
class RelaxStats:
    """Diagnostics for one relaxed solve."""

    live: int = 0
    support: int = 0
    support_padded: int = 0
    iters: int = 0
    lp_seconds: float = 0.0
    repair_seconds: float = 0.0
    repair_rounds: int = 0
    #: final fractional solution (tests/diagnostics; [W+1] float32)
    x: Optional[np.ndarray] = field(default=None, repr=False)


def lp_to_device(lp: RelaxLP, device) -> RelaxLP:
    """Upload the LP's fields (a leading scenario axis rides along)."""
    return RelaxLP(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                     for a in lp))


def rho_step(iters: int) -> np.float32:
    """The float32 constant c of rho = i * c + 1: the JAX program's
    RHO0 * (1 + RHO_GROWTH * i / iters) as XLA rewrites it (the divide
    by the constant becomes a multiply by its float32 reciprocal, the
    constants fold to RHO_GROWTH * (1 / iters) in float32, and the
    multiply by RHO0 = 1 goes)."""
    return np.float32(RHO_GROWTH) * (np.float32(1.0) / np.float32(iters))


def _rho(i: int, iters: int) -> np.float32:
    """rho of iteration i: i * rho_step(iters) + 1, each op rounded to
    float32."""
    return np.float32(np.float32(i) * rho_step(iters)) + np.float32(1.0)


#: XLA:CPU's tree-reduction window: a reduce over more than WINDOW
#: elements is split into a reduce-window of WINDOW, then a reduce
WINDOW = 32
#: the widest F whose order the tests hold bit for bit against the JAX
#: program (ROADMAP Queue C item 8); ``sum_order`` refuses a wider one
MAX_SUM_COLUMNS = 128


def sum_order(n: int) -> tuple[int, int]:
    """XLA:CPU's order of the pull's sum over F = n, as tier-1 compiles
    it (AVX, the conftest flags).

    For n <= 32, (V, E): LLVM vectorises the reduce's reassociable loop
    over F into V lanes: lane j adds elements j, j + V, ... below E in
    order (lane 0 from +0.0, the others from -0.0, so a lane with no
    element is the identity); the lanes then fold by halves (lane i +=
    lane i + V/2, down to lane 0: x86's lowering of
    ``llvm.vector.reduce.fadd``); elements E .. n-1 are added after, in
    order (the scalar remainder loop). Read from the optimised LLVM IR
    at n = 1-32: V = the next power of two for n <= 8 (one masked
    vector), 4 for 9-12 and 8 for 13-15 (masked loops), and above E =
    4 * (n // 4) with V = 8 when 8 divides E, else 4.

    For n > 32, (0, P): XLA splits the reduce into a reduce-window of
    ``WINDOW`` elements, stride ``WINDOW``, over F padded to the next
    multiple of ``WINDOW`` with P = (pad // 2) elements in front (the
    rest behind), then a reduce over the ceil(n / 32) windows. Each
    window adds its elements in order from +0.0, skipping the padding;
    the windows then add in order from +0.0. Read from the reduce-window
    and the fusion that consumes it (``--xla_dump_to``) at n = 33, 40,
    48, 64, 96, 128 and 200, for one LP and under ``vmap``, at 129 and
    257 rows: the same split at every row count. Above
    ``MAX_SUM_COLUMNS`` it raises: no test holds that order (above 32
    windows XLA may split the reduce again).

    Both ``lp_step_body`` and ``csrc/relax_lp.cu`` follow it."""
    if n > MAX_SUM_COLUMNS:
        raise ValueError(
            f"the relaxed LP's sum over {n} flavor-resource columns: "
            f"XLA:CPU's order is held only up to {MAX_SUM_COLUMNS} "
            f"(ROADMAP Queue C item 8)")
    if n > WINDOW:
        n_w = -(-n // WINDOW)
        return 0, (n_w * WINDOW - n) // 2
    if n <= 8:
        v = 1
        while v < n:
            v *= 2
        return v, n
    if n < 16:
        return (4 if n <= 12 else 8), n
    e = 4 * (n // 4)
    return (8 if e % 8 == 0 else 4), e


def sum_in_order(prod: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in ``sum_order``'s order, every add
    rounded to float32."""
    n = prod.shape[-1]
    v, e = sum_order(n)
    if v == 0:
        out = torch.zeros(prod.shape[:-1], dtype=prod.dtype,
                          device=prod.device)
        for lo in range(-e, n, WINDOW):
            acc = torch.zeros_like(out)
            for f in range(max(lo, 0), min(lo + WINDOW, n)):
                acc = acc + prod[..., f]
            out = out + acc
        return out
    lanes = []
    for j in range(min(v, e)):
        acc = prod[..., j] + 0.0 if j == 0 else prod[..., j]
        for f in range(j + v, e, v):
            acc = acc + prod[..., f]
        lanes.append(acc)
    while v > 1:
        v //= 2
        for i in range(len(lanes) - v):
            lanes[i] = lanes[i] + lanes[i + v]
        lanes = lanes[:v]
    out = lanes[0]
    for f in range(e, n):
        out = out + prod[..., f]
    return out


def lp_step_body(lp: RelaxLP, x: torch.Tensor, i: int,
                 iters: int) -> torch.Tensor:
    """One projected-gradient iteration on one scenario's tensors."""
    C = lp.cq_node.shape[0]
    N1 = lp.parent.shape[0]
    F = lp.r.shape[1]
    d_max = lp.path_cq.shape[1]
    dev = lp.r.device
    cqid = lp.wl_cqid.long()
    load_cq = torch.zeros((C + 1, F), dtype=torch.float32,
                          device=dev).index_add_(0, cqid, lp.r * x[:, None])
    u = torch.zeros((N1, F), dtype=torch.float32, device=dev).index_add_(
        0, lp.cq_node.long(), load_cq[:C])
    # kernels.accumulate_full_charge: every level adds into the old u
    # (mode="drop": a parent outside [0, N+1) drops its row)
    keep = (lp.parent >= 0) & (lp.parent < N1)
    par = lp.parent[keep].long()
    depth = lp.depth[keep]
    for d in range(d_max - 1, 0, -1):
        src = torch.where((depth == d)[:, None], u[keep], 0.0)
        u = u.index_add(0, par, src)
    # RELATIVE violation, clipped: scale-invariant pricing
    over = torch.clamp((u - lp.slack) / lp.scale, 0.0, 1.0)
    on_path = over[lp.path_cq.long()]                   # [C, D, F]
    price = on_path[:, 0]
    for k in range(1, d_max):
        price = price + on_path[:, k]
    # JAX clamps the padding id C to row C-1 (never a live row)
    gather = torch.clamp(cqid, 0, C - 1)
    rnorm = lp.r / torch.clamp(lp.r.amax(dim=1, keepdim=True), min=1.0)
    # the sum over F in XLA:CPU's order (sum_order)
    pull = sum_in_order(rnorm * price[gather])
    rho = torch.tensor(_rho(i, iters), device=dev)
    g = (lp.s * torch.tensor(ALPHA, dtype=torch.float32, device=dev)
         - rho * pull)
    x = torch.clamp(x + g * torch.tensor(ETA, dtype=torch.float32,
                                         device=dev), 0.0, 1.0)
    return torch.where(lp.live, x, 0.0)


def lp_loop(lp: RelaxLP, iters: int) -> torch.Tensor:
    """The full fixed-iteration LP solve in plain PyTorch: x [W+1]
    float32. With a leading scenario axis on every field (the JAX
    package's ``vmap``), each scenario runs alone: x [S, W+1]."""
    if lp.r.dim() == 3:
        return torch.stack([lp_loop(RelaxLP(*(a[i] for a in lp)), iters)
                            for i in range(lp.r.shape[0])])
    x = torch.where(lp.live, 0.5, 0.0).to(torch.float32)
    if lp.cq_node.shape[0] == 0:
        return x  # no ClusterQueue: no row is live
    for i in range(iters):
        x = lp_step_body(lp, x, i, iters)
    return x


# ---------------------------------------------------------------------------
# LP assembly (host)
# ---------------------------------------------------------------------------


def _full_charge_np(parent: np.ndarray, depth: np.ndarray,
                    values: np.ndarray, d_max: int) -> np.ndarray:
    """Numpy twin of the full-charge accumulation for the per-drain
    constant headroom tensors."""
    u = values.copy()
    for d in range(d_max - 1, 0, -1):
        rows = depth == d
        np.add.at(u, parent[rows], u[rows])
    return u


def build_lp(problem: SolverProblem) -> RelaxLP:
    """Assemble the LP tensors from a (padded) lean export."""
    C = problem.n_cqs
    W1 = problem.wl_cqid.shape[0]
    cqid = np.asarray(problem.wl_cqid)
    valid = np.asarray(problem.wl_valid)
    live = np.zeros(W1, dtype=bool)
    live[:-1] = (cqid[:-1] < C) & valid[:-1].any(axis=1)

    # request under the FIRST valid flavor option; the repair pass
    # re-runs the exact fungibility policy, so the relaxation only
    # needs one representative request vector per row
    k0 = np.argmax(valid, axis=1).astype(np.int64)
    r = np.asarray(problem.wl_req)[np.arange(W1), k0].astype(np.float32)
    r[~live] = 0.0

    prio = np.asarray(problem.wl_prio).astype(np.float32)
    ts = np.asarray(problem.wl_ts).astype(np.float32)
    p_lo = float(prio[live].min()) if live.any() else 0.0
    p_hi = float(prio[live].max()) if live.any() else 0.0
    t_hi = float(ts[live].max()) if live.any() else 0.0
    s = ((prio - p_lo) / max(1.0, p_hi - p_lo)
         + 0.25 * (1.0 - ts / max(1.0, t_hi))).astype(np.float32)
    s[~live] = 0.0

    # capacity rows: subtree quota + borrowing allowance (non-root
    # nodes without a limit only bind at their ancestors), minus the
    # full-charge total of current CQ usage under the node
    subtree = np.asarray(problem.subtree).astype(np.float32)
    extra = np.where(
        np.asarray(problem.has_borrow),
        np.asarray(problem.borrow_limit).astype(np.float32),
        np.where(np.asarray(problem.has_parent)[:, None],
                 UNBOUNDED, np.float32(0.0)))
    cap = np.minimum(subtree + extra, UNBOUNDED)
    is_cq = np.zeros(problem.parent.shape[0], dtype=bool)
    is_cq[problem.cq_node] = True
    usage_cq = np.where(is_cq[:, None],
                        np.asarray(problem.usage0), 0).astype(np.float32)
    d_max = problem.path.shape[1]
    base = _full_charge_np(np.asarray(problem.parent),
                           np.asarray(problem.depth), usage_cq, d_max)
    slack = np.maximum(cap - base, 0.0).astype(np.float32)
    scale = np.maximum(slack, 1.0).astype(np.float32)

    return RelaxLP(
        r=r, s=s, live=live, wl_cqid=cqid.astype(np.int32),
        cq_node=np.asarray(problem.cq_node).astype(np.int32),
        path_cq=np.asarray(problem.path)[problem.cq_node].astype(np.int32),
        parent=np.asarray(problem.parent).astype(np.int32),
        depth=np.asarray(problem.depth).astype(np.int32),
        slack=slack, scale=scale)


# ---------------------------------------------------------------------------
# Rounding: deterministic support selection (host)
# ---------------------------------------------------------------------------


def strict_rows(problem: SolverProblem) -> np.ndarray:
    """[W+1] mask of rows whose CQ is StrictFIFO — the ONE definition
    of the strict-semantics rule both the rounding (strict rows always
    join the support) and the plan assembly (strict rows never park)
    share."""
    cq = np.asarray(problem.wl_cqid)
    strict = np.zeros(cq.shape[0], dtype=bool)
    m = cq < problem.n_cqs
    strict[m] = np.asarray(problem.cq_strict)[cq[m]].astype(bool)
    return strict


def rounded_support(x: np.ndarray, problem: SolverProblem,
                    live: np.ndarray, threshold: float = 0.5,
                    slack_frac: float = 0.25, slack_min: int = 4,
                    strict: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean support mask over the real workload rows [W].

    Selected: live rows with x >= threshold; every live StrictFIFO row
    (a strict head must never be skipped); and per CQ, extra rows by
    (-x, FIFO rank) up to an allowance of ``slack_min + ceil(slack_frac
    * selected + unselected fractional mass)``, so a diffuse symmetric
    solution still rounds to the exact drain's FIFO prefix.
    """
    C = problem.n_cqs
    W = problem.wl_cqid.shape[0] - 1
    cq = np.asarray(problem.wl_cqid)[:W]
    livew = np.asarray(live)[:W]
    xw = np.asarray(x)[:W]
    if strict is None:
        strict = strict_rows(problem)
    sel = livew & ((xw >= threshold) | strict[:W])
    cand = np.nonzero(livew & ~sel)[0]
    if cand.size:
        rank = np.asarray(problem.wl_rank)[:W]
        order = cand[np.lexsort((rank[cand], -xw[cand], cq[cand]))]
        cqs = cq[order]
        starts = np.r_[True, cqs[1:] != cqs[:-1]]
        idx = np.arange(order.size)
        gi = idx - np.maximum.accumulate(np.where(starts, idx, 0))
        n_sel = np.bincount(cq[sel], minlength=C + 1)
        mass = np.bincount(cq[cand], weights=xw[cand], minlength=C + 1)
        allow = (slack_min
                 + np.ceil(slack_frac * n_sel + mass)).astype(np.int64)
        sel[order[gi < allow[cqs]]] = True
    return sel


# ---------------------------------------------------------------------------
# Repair: the exact lean drain on the compacted support
# ---------------------------------------------------------------------------


def restrict_problem(problem: SolverProblem, sel_idx: np.ndarray,
                     target_w: int) -> SolverProblem:
    """Compact a padded lean problem to the support rows (+ inert null
    fills up to ``target_w`` and the trailing null row). Node/CQ
    tensors are untouched; per-CQ FIFO rank ORDER is preserved because
    the gather keeps ascending row order and ranks ride along."""
    W1 = problem.wl_cqid.shape[0]
    rows = np.concatenate([
        np.asarray(sel_idx, dtype=np.int64),
        np.full(target_w + 1 - len(sel_idx), W1 - 1, dtype=np.int64),
    ])
    return dataclasses.replace(
        problem,
        wl_cqid=np.ascontiguousarray(problem.wl_cqid[rows]),
        wl_rank=np.ascontiguousarray(problem.wl_rank[rows]),
        wl_prio=np.ascontiguousarray(problem.wl_prio[rows]),
        wl_ts=np.ascontiguousarray(problem.wl_ts[rows]),
        wl_uid=np.ascontiguousarray(problem.wl_uid[rows]),
        wl_req=np.ascontiguousarray(problem.wl_req[rows]),
        wl_valid=np.ascontiguousarray(problem.wl_valid[rows]),
    )


def repair(problem: SolverProblem, sel: np.ndarray, live: np.ndarray,
           pad_to: int = 0, strict: Optional[np.ndarray] = None,
           device="cuda") -> tuple[tuple, RelaxStats]:
    """Run the exact lean drain on the rounded support (on ``device``)
    and scatter the plan back to full workload indices.

    Returns the full ``solve_backlog`` contract — (admitted, opt,
    admit_round, parked, rounds, usage), numpy, [W+1]-shaped — plus
    stats. ``pad_to`` is the caller's sticky support pad target, so
    steady-state drains keep one support width.
    """
    from kueue_oss_tpu_torch.solver import kernels

    W1 = problem.wl_cqid.shape[0]
    sel_idx = np.nonzero(sel)[0]
    S = len(sel_idx)
    target = max(pow2(S + 1) - 1, pad_to)
    stats = RelaxStats(live=int(np.asarray(live)[:-1].sum()), support=S,
                       support_padded=target)

    t0 = time.monotonic()
    sub = restrict_problem(problem, sel_idx, target)
    out = kernels.solve_backlog(kernels.to_device(sub,
                                                  resolve_device(device)))
    out = tuple(a.cpu().numpy() for a in out)
    stats.repair_seconds = time.monotonic() - t0

    adm_s, opt_s, round_s, parked_s, rounds, usage = out
    admitted = np.zeros(W1, dtype=bool)
    opt = np.zeros(W1, dtype=np.int32)
    admit_round = np.zeros(W1, dtype=np.int32)
    admitted[sel_idx] = adm_s[:S].astype(bool)
    opt[sel_idx] = opt_s[:S]
    admit_round[sel_idx] = np.where(adm_s[:S].astype(bool),
                                    round_s[:S], 0)
    # rows the plan leaves unadmitted park exactly like the exact
    # drain's quiescent state: every live BestEffortFIFO row; never a
    # StrictFIFO row (their heads block in place)
    if strict is None:
        strict = strict_rows(problem)
    parked = np.asarray(live, dtype=bool) & ~admitted & ~strict
    parked[-1] = False
    admitted[-1] = False
    stats.repair_rounds = int(rounds)
    return (admitted, opt, admit_round, parked, rounds, usage), stats


# ---------------------------------------------------------------------------
# The whole arm
# ---------------------------------------------------------------------------


def solve_relaxed(problem: SolverProblem, *, iters: int = 32,
                  threshold: float = 0.5, mesh=None, pad_to: int = 0,
                  device="cuda") -> tuple[tuple, RelaxStats]:
    """Relax -> round -> repair one padded lean problem on ``device``:
    the LP through ``cuda_relax.relax_lp`` (the kernel on the card, the
    plain loop on the CPU), the repair through the exact lean drain. The
    emitted plan is exactly feasible (it IS a lean-drain plan over the
    support)."""
    from kueue_oss_tpu_torch.solver import cuda_relax

    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded relaxed LP: ROADMAP Queue A item 9")
    device = resolve_device(device)
    lp = build_lp(problem)
    t0 = time.monotonic()
    index = None if device.type == "cpu" else cuda_relax.lp_index(
        lp.wl_cqid, lp.parent, lp.cq_node, problem.n_cqs, live=lp.live)
    x = cuda_relax.relax_lp(lp_to_device(lp, device), iters,
                            index).cpu().numpy()
    lp_seconds = time.monotonic() - t0

    strict = strict_rows(problem)
    sel = rounded_support(x, problem, lp.live, threshold=threshold,
                          strict=strict)
    out, stats = repair(problem, sel, lp.live, pad_to=pad_to,
                        strict=strict, device=device)
    stats.iters = iters
    stats.lp_seconds = lp_seconds
    stats.x = x
    return out, stats


def plans_agree(plan_a: tuple, plan_b: tuple, n_workloads: int) -> bool:
    """Semantic plan equality over the real rows: same admitted set,
    same parked set, same chosen flavor option per admitted row.
    ``admit_round``/``rounds`` are NOT compared — the relaxed arm's
    repair runs over a compacted axis, so its round numbering differs
    while the decisions do not.
    """
    W = n_workloads
    adm_a = np.asarray(plan_a[0])[:W].astype(bool)
    adm_b = np.asarray(plan_b[0])[:W].astype(bool)
    if not np.array_equal(adm_a, adm_b):
        return False
    if not np.array_equal(np.asarray(plan_a[3])[:W].astype(bool),
                          np.asarray(plan_b[3])[:W].astype(bool)):
        return False
    return bool(np.array_equal(np.asarray(plan_a[1])[:W][adm_a],
                               np.asarray(plan_b[1])[:W][adm_b]))
