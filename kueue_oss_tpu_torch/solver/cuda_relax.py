"""The relaxed LP's CUDA kernel: every projected-gradient iteration of
every scenario in one launch of ``csrc/relax_lp.cu``, each scenario on a
thread-block cluster.

Counterpart of the JAX package's ``jit(lp_loop)`` (solver/relax.py) and
``jit(vmap(lp_loop))`` (sim/batch.py ``solve_scenarios_relax``), XLA
programs, not Pallas. ``relax_lp`` launches the kernel for CUDA tensors
or raises, takes the plain ``relax.lp_loop`` for CPU tensors, and counts
its launches (``relax_lp.launches``; ``.scenarios``, the clusters those
launches ran; ``.clusters``, launches by cluster size; ``.layouts``,
launches by where the row arrays lived). ``lp_index`` builds the
kernel's lists on the host once per problem: the CQ-sorted rows, the
child lists, and the cut of each scenario's ClusterQueues into
``cluster`` blocks of whole ClusterQueues (``cluster_size``,
``partition``). The kernel shares the build of ``cuda_tas`` (every
``csrc/*.cu`` in one nvcc call, one library).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kueue_oss_tpu_torch.solver.relax import (
    RelaxLP,
    lp_loop,
    rho_step,
    sum_order,
)

_FLOAT = ("r", "s", "slack", "scale")
#: the largest cluster, the portable size
MAX_CLUSTER = 8
#: rows a block should hold before the cluster grows
ROWS_PER_BLOCK = 2048
#: SMs of an H100: the clusters of one launch should fit at once
N_SMS = 132
#: dynamic shared memory a block may take (227 KB less the kernel's
#: static shared memory)
SHARED_BYTES = 232_448 - 128
#: where the row arrays live, by the kernel's (r_global, x_global)
LAYOUTS = {(0, 0): "shared", (1, 0): "r_global", (1, 1): "global"}


class LPIndex(NamedTuple):
    """The kernel's lists (int32, leading scenario axis) and its cut:
    every row sorted stably by CQ (the padding id C last) with CSR
    offsets, nodes with a parent in [0, N+1) sorted stably by parent with
    CSR offsets, the CQ at each node (-1 for none), and each scenario's
    CQ ranges of its ``cluster`` blocks, with the largest block's rows
    and CQs."""

    rows: np.ndarray     # [S, W+1]
    row_off: np.ndarray  # [S, C+1]
    kids: np.ndarray     # [S, N+1]
    kid_off: np.ndarray  # [S, N+2]
    node_cq: np.ndarray  # [S, N+1]
    part: np.ndarray     # [S, cluster+1]
    cluster: int
    max_rows: int
    max_cqs: int


def cluster_size(n_scenarios: int, n_rows: int, n_cqs: int) -> int:
    """Blocks per scenario: the smallest power of two that leaves at most
    ``ROWS_PER_BLOCK`` rows a block, capped at ``MAX_CLUSTER``, at the
    ClusterQueue count and at what fills the card once."""
    k = 1
    while (k < MAX_CLUSTER and n_rows > k * ROWS_PER_BLOCK
           and 2 * k <= n_cqs and n_scenarios * 2 * k <= N_SMS):
        k *= 2
    return k


def partition(row_off: np.ndarray, k: int) -> np.ndarray:
    """Cut C ClusterQueues (CSR row offsets [C+1]) into k contiguous
    ranges of whole ClusterQueues, each at least one, with their rows
    balanced: boundary j is the CQ edge nearest j / k of the rows.
    Returns the k+1 CQ boundaries."""
    n_cqs = row_off.shape[0] - 1
    if not 1 <= k <= n_cqs:
        raise ValueError(f"relax_lp: {k} blocks for {n_cqs} ClusterQueues")
    total = int(row_off[-1])
    part = np.zeros(k + 1, dtype=np.int32)
    part[k] = n_cqs
    for j in range(1, k):
        target = total * j / k
        c = int(np.searchsorted(row_off, target))
        if c > 0 and target - row_off[c - 1] <= row_off[c] - target:
            c -= 1
        part[j] = min(max(c, part[j - 1] + 1), n_cqs - (k - j))
    return part


def lp_index(wl_cqid: np.ndarray, parent: np.ndarray, cq_node: np.ndarray,
             n_cqs: int, live: np.ndarray, cluster: int = None) -> LPIndex:
    """Build the lists from [S, W+1] / [S, N+1] / [S, C] host arrays (a
    1-D input is one scenario). ``cluster``, a test hook, overrides
    ``cluster_size`` with a size it could return: a power of two up to
    ``MAX_CLUSTER`` and the ClusterQueue count. Raises on a ClusterQueue
    id outside [0, C], a live row outside the ClusterQueues (the kernel
    gives every row outside them x = 0), two ClusterQueues on one node,
    or another cluster size."""
    cqid = np.atleast_2d(np.asarray(wl_cqid))
    par = np.atleast_2d(np.asarray(parent))
    nodes = np.atleast_2d(np.asarray(cq_node))
    S, W1 = cqid.shape
    N1 = par.shape[1]
    if cqid.size and (cqid.min() < 0 or cqid.max() > n_cqs):
        raise ValueError(f"relax_lp: wl_cqid outside [0, {n_cqs}]")
    if np.any(np.atleast_2d(live) & (cqid >= n_cqs)):
        raise ValueError("relax_lp: a live row outside the ClusterQueues")
    for row in nodes:
        if np.unique(row).size != row.size:
            raise ValueError("relax_lp: two ClusterQueues share a node")
    if cluster is None:
        k = cluster_size(S, W1, n_cqs)
    elif (1 <= cluster <= min(MAX_CLUSTER, max(n_cqs, 1))
          and cluster & (cluster - 1) == 0):
        k = cluster
    else:
        raise ValueError(f"relax_lp: a cluster of {cluster} for {n_cqs} "
                         f"ClusterQueues")
    rows = np.zeros((S, W1), dtype=np.int32)
    row_off = np.zeros((S, n_cqs + 1), dtype=np.int32)
    kids = np.zeros((S, N1), dtype=np.int32)
    kid_off = np.zeros((S, N1 + 1), dtype=np.int32)
    node_cq = np.full((S, N1), -1, dtype=np.int32)
    part = np.zeros((S, k + 1), dtype=np.int32)
    max_rows = max_cqs = 1
    for b in range(S):
        order = np.argsort(cqid[b], kind="stable")
        rows[b] = order
        row_off[b] = np.searchsorted(cqid[b][order], np.arange(n_cqs + 1))
        p = par[b]
        ok = np.nonzero((p >= 0) & (p < N1))[0]
        order = ok[np.argsort(p[ok], kind="stable")]
        kids[b, :order.size] = order
        kid_off[b] = np.searchsorted(p[order], np.arange(N1 + 1))
        node_cq[b, nodes[b]] = np.arange(n_cqs, dtype=np.int32)
        if n_cqs:
            part[b] = partition(row_off[b], k)
            max_rows = max(max_rows,
                           int(np.diff(row_off[b][part[b]]).max()))
            max_cqs = max(max_cqs, int(np.diff(part[b]).max()))
    return LPIndex(rows, row_off, kids, kid_off, node_cq, part, k, max_rows,
                   max_cqs)


def index_on(index: LPIndex, device) -> LPIndex:
    """The index with its arrays as tensors on ``device`` (made once,
    outside timed launches)."""
    return LPIndex(*(torch.as_tensor(a, device=device) for a in index[:6]),
                   *index[6:])


def shared_words(index: LPIndex, F: int, N1: int) -> dict:
    """int32 words of one block's state: the part that always sits in
    shared memory (loads by parity, price, u, u_next, the child lists and
    depths) and the row arrays (x, 0.05 * s, the CQ map; r and
    r / max(r, 1))."""
    return {"tree": 3 * index.max_cqs * F + 2 * N1 * F + 3 * N1 + 1,
            "x": 3 * index.max_rows, "r": 2 * F * index.max_rows}


def layout(index: LPIndex, F: int, N1: int) -> tuple[int, int]:
    """(r_global, x_global): the row arrays in shared memory where they
    fit, else r (and then x) in a global scratch buffer. Raises when not
    even the tree fits."""
    w = shared_words(index, F, N1)
    for flags, used in (((0, 0), w["tree"] + w["x"] + w["r"]),
                        ((1, 0), w["tree"] + w["x"]),
                        ((1, 1), w["tree"])):
        if 4 * used <= SHARED_BYTES:
            return flags
    raise ValueError(f"relax_lp: the tree's {4 * w['tree']} bytes do not "
                     f"fit in one block's shared memory")


def block_threads(index: LPIndex, F: int, N1: int) -> int:
    """Threads a block: enough for the widest step (its rows, its CQs'
    (CQ, f) pairs, the tree's (node, f) pairs) in warps, 1024 at most."""
    widest = max(index.max_rows, index.max_cqs * F, N1 * F)
    return min(1024, 32 * ((widest + 31) // 32))


def _bind():
    from kueue_oss_tpu_torch.solver import cuda_tas

    lib = cuda_tas._library()
    fn = lib.kueue_relax_lp
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_float]
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                               ctypes.c_int]
                       + [ctypes.c_void_p] * 17)
        fn.restype = ctypes.c_int
    return fn


def relax_lp(lp: RelaxLP, iters: int, index: LPIndex = None
             ) -> torch.Tensor:
    """x after ``iters`` projected-gradient steps: [W+1] float32, or
    [S, W+1] when every field has a leading scenario axis.

    CPU tensors take ``relax.lp_loop``; CUDA tensors launch the kernel
    (``index``, required there, from ``lp_index`` on the host arrays the
    LP was made from) or raise. Anything else raises.
    """
    device = lp.r.device
    if device.type == "cpu":
        return lp_loop(lp, iters)
    if device.type != "cuda":
        raise ValueError(f"relax_lp: unsupported device {device}")
    batched = lp.r.dim() == 3
    lpb = lp if batched else RelaxLP(*(a.unsqueeze(0) for a in lp))
    S, W1, F = lpb.r.shape
    C = lpb.cq_node.shape[1]
    N1 = lpb.parent.shape[1]
    D = lpb.path_cq.shape[2]
    for name, t in zip(RelaxLP._fields, lpb):
        want = (torch.float32 if name in _FLOAT
                else torch.bool if name == "live" else torch.int32)
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"relax_lp: {name} must be a contiguous {want} "
                             f"tensor on {device}, got {t.dtype} on "
                             f"{t.device}")
        if t.shape[0] != S:
            raise ValueError(f"relax_lp: {name} has {t.shape[0]} scenarios, "
                             f"r has {S}")
    shapes = {"s": (S, W1), "live": (S, W1), "wl_cqid": (S, W1),
              "cq_node": (S, C), "path_cq": (S, C, D), "parent": (S, N1),
              "depth": (S, N1), "slack": (S, N1, F), "scale": (S, N1, F)}
    for name, want in shapes.items():
        if tuple(getattr(lpb, name).shape) != want:
            raise ValueError(f"relax_lp: {name} is "
                             f"{tuple(getattr(lpb, name).shape)}, expected "
                             f"{want}")
    if F < 1 or D < 1:
        raise ValueError(f"relax_lp: F = {F} and D = {D} must be >= 1")
    x = torch.empty((S, W1), dtype=torch.float32, device=device)
    if C == 0:  # no ClusterQueue: no row is live
        x.copy_(torch.where(lpb.live, 0.5, 0.0))
        return x if batched else x[0]
    if index is None:
        raise ValueError("relax_lp: a CUDA launch needs the LP's index "
                         "(cuda_relax.lp_index)")
    want = {"rows": (S, W1), "row_off": (S, C + 1), "kids": (S, N1),
            "kid_off": (S, N1 + 1), "node_cq": (S, N1),
            "part": (S, index.cluster + 1)}
    for name, shape in want.items():
        if tuple(getattr(index, name).shape) != shape:
            raise ValueError(f"relax_lp: index.{name} is "
                             f"{tuple(getattr(index, name).shape)}, "
                             f"expected {shape}")
    idx = index_on(index, device)
    r_global, x_global = layout(index, F, N1)
    words = shared_words(index, F, N1)
    in_shared = (words["tree"] + (0 if x_global else words["x"])
                 + (0 if r_global else words["r"]))
    per_block = ((words["x"] if x_global else 0)
                 + (words["r"] if r_global else 0))
    scratch = torch.empty(max(1, S * index.cluster * per_block),
                          dtype=torch.float32, device=device)
    lanes, lane_end = sum_order(F)
    fn = _bind()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(S, index.cluster, block_threads(index, F, N1), W1, F, C,
                N1, D, iters,
                float(rho_step(iters)), lanes, lane_end, index.max_rows,
                index.max_cqs, r_global, x_global, per_block, 4 * in_shared,
                *(getattr(lpb, name).data_ptr() for name in (
                    "r", "s", "live", "wl_cqid", "path_cq", "depth",
                    "slack", "scale")),
                *(t.data_ptr() for t in idx[:6]), scratch.data_ptr(),
                x.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"relax_lp kernel launch failed: CUDA error {rc}")
    relax_lp.launches += 1
    relax_lp.scenarios += S
    relax_lp.clusters[index.cluster] += 1
    relax_lp.layouts[LAYOUTS[(r_global, x_global)]] += 1
    return x if batched else x[0]


def reset_counts() -> None:
    """Zero ``relax_lp``'s launch counters."""
    relax_lp.launches = 0
    relax_lp.scenarios = 0
    relax_lp.clusters = collections.Counter()
    relax_lp.layouts = collections.Counter()


#: CUDA kernel launches made through ``relax_lp`` in this process, the
#: scenarios (clusters) those launches solved, and the launches by
#: cluster size and by layout
reset_counts()
