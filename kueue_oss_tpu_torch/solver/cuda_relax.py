"""The relaxed LP's CUDA kernel: every projected-gradient iteration of
every scenario in one launch of ``csrc/relax_lp.cu``.

Counterpart of the JAX package's ``jit(lp_loop)`` (solver/relax.py) and
``jit(vmap(lp_loop))`` (sim/batch.py ``solve_scenarios_relax``), XLA
programs, not Pallas. ``relax_lp`` launches the kernel for CUDA tensors
(one block per scenario) or raises, takes the plain
``relax.lp_loop`` for CPU tensors, and counts its launches
(``relax_lp.launches``; ``.scenarios``, the blocks those launches ran).
The kernel shares the build of ``cuda_tas`` (every ``csrc/*.cu`` in one
nvcc call, one library).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kueue_oss_tpu_torch.solver.relax import RelaxLP, lp_loop, rho_step

_FLOAT = ("r", "s", "slack", "scale")


class LPIndex(NamedTuple):
    """The kernel's row and child lists (int32, leading scenario axis):
    rows with 0 <= wl_cqid < C sorted stably by CQ with CSR offsets, and
    nodes with a parent in [0, N+1) sorted stably by parent with CSR
    offsets."""

    rows: np.ndarray     # [S, W+1]
    row_off: np.ndarray  # [S, C+1]
    kids: np.ndarray     # [S, N+1]
    kid_off: np.ndarray  # [S, N+2]


def lp_index(wl_cqid: np.ndarray, parent: np.ndarray, cq_node: np.ndarray,
             n_cqs: int) -> LPIndex:
    """Build the lists from [S, W+1] / [S, N+1] / [S, C] host arrays (a
    1-D input is one scenario). Raises on a ClusterQueue id outside
    [0, C] or two ClusterQueues on one node."""
    cqid = np.atleast_2d(np.asarray(wl_cqid))
    par = np.atleast_2d(np.asarray(parent))
    nodes = np.atleast_2d(np.asarray(cq_node))
    S, W1 = cqid.shape
    N1 = par.shape[1]
    if cqid.size and (cqid.min() < 0 or cqid.max() > n_cqs):
        raise ValueError(f"relax_lp: wl_cqid outside [0, {n_cqs}]")
    for row in nodes:
        if np.unique(row).size != row.size:
            raise ValueError("relax_lp: two ClusterQueues share a node")
    rows = np.zeros((S, W1), dtype=np.int32)
    row_off = np.zeros((S, n_cqs + 1), dtype=np.int32)
    kids = np.zeros((S, N1), dtype=np.int32)
    kid_off = np.zeros((S, N1 + 1), dtype=np.int32)
    for b in range(S):
        order = np.argsort(cqid[b], kind="stable")
        keyed = cqid[b][order]
        n = int(np.searchsorted(keyed, n_cqs))
        rows[b, :n] = order[:n]
        row_off[b] = np.searchsorted(keyed, np.arange(n_cqs + 1))
        p = par[b]
        ok = np.nonzero((p >= 0) & (p < N1))[0]
        order = ok[np.argsort(p[ok], kind="stable")]
        kids[b, :order.size] = order
        kid_off[b] = np.searchsorted(p[order], np.arange(N1 + 1))
    return LPIndex(rows, row_off, kids, kid_off)


def _bind():
    from kueue_oss_tpu_torch.solver import cuda_tas

    lib = cuda_tas._library()
    fn = lib.kueue_relax_lp
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 16)
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
    idx = [torch.as_tensor(a, device=device) for a in index]
    scratch = torch.empty(S * (2 * C + 3 * N1) * F, dtype=torch.float32,
                          device=device)
    fn = _bind()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(S, W1, F, C, N1, D, iters, float(rho_step(iters)),
                *(getattr(lpb, name).data_ptr() for name in (
                    "r", "s", "live", "wl_cqid", "cq_node", "path_cq",
                    "depth", "slack", "scale")),
                *(t.data_ptr() for t in idx), scratch.data_ptr(),
                x.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"relax_lp kernel launch failed: CUDA error {rc}")
    relax_lp.launches += 1
    relax_lp.scenarios += S
    return x if batched else x[0]


#: CUDA kernel launches made through ``relax_lp`` in this process, and the
#: scenarios (blocks) those launches solved
relax_lp.launches = 0
relax_lp.scenarios = 0
