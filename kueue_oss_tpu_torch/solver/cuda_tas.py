"""The TAS CUDA kernels: the leaf-state pass and the sequential placer.

Counterpart of ``kueue_oss_tpu/solver/pallas_tas.py`` and of the jitted
``lax.scan`` around it (``kueue_oss_tpu/solver/tas_kernels.py:250-283``).

- ``leaf_states`` is the one-for-one port of the Pallas kernel: the
  fused phase-1 leaf pass of TAS placement (fillInCounts' leaf block,
  tas_flavor_snapshot.go:1568) computes, for every leaf domain, how many
  pods fit (``st``), whether the leader fits (``ls``) and how many pods
  fit beside the leader (``swl``). It launches ``csrc/leaf_states.cu``
  for a CUDA tensor and takes ``leaf_states_reference``, a line-for-line
  port of ``pallas_tas.leaf_states_reference``, for a CPU tensor.
- ``tas_place_sequential`` is the kernel redesigned for Hopper: the
  drain's whole sequential TAS placement (``make_sequential_placer_ext``
  with the leaf pass fused in) in one launch of ``csrc/tas_place.cu``,
  on a ``PlacerTree``. Its plain version,
  ``tas_place_sequential_reference``, is the sequential placer of
  ``tas_kernels`` with the all-PyTorch leaf pass, so on the card the
  oracle runs no hand kernel.

Each wrapper launches its kernel for CUDA tensors or raises (never falls
back), takes the plain version only for CPU tensors, and counts its
launches (``leaf_states.launches``; ``tas_place_sequential.launches`` and
``.steps``, the podsets placed). The source notes in ``csrc/`` give each
kernel's bound and design.

``build`` compiles every ``csrc/*.cu`` with one ``nvcc`` call at first
use into one library under ``_build/`` beside the package, keyed on a
hash of the sources, headers and flags, bound with ``ctypes`` (no
PyTorch headers, so the build takes seconds). ``ptxas``' register,
shared-memory and spill report is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from kueue_oss_tpu_torch.solver.ops import floor_div

BIG = 1 << 30

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: shared memory one block may use on an H100 (227 KB), static included
SHARED_LIMIT_BYTES = 232_448
#: tas_place.cu's static shared memory (its block-reduction scratch)
PLACE_STATIC_SHARED_BYTES = 512

_lib = None


def leaf_states_reference(leaf_capacity, per_pod, leader_per_pod,
                          has_leader):
    """Plain PyTorch leaf pass (pallas_tas.leaf_states_reference).

    leaf_capacity [D, R] int32; per_pod / leader_per_pod [R] int32;
    has_leader bool or 0-d bool tensor. Returns (st, swl, ls) [D] int32.
    """
    nz = per_pod > 0
    safe_req = torch.clamp(per_pod, min=1)[None, :]
    per_dom = torch.where(nz[None, :], floor_div(leaf_capacity, safe_req),
                          BIG)
    st = torch.clamp(per_dom.amin(dim=1), max=BIG)
    lnz = leader_per_pod > 0
    fits_leader = (~lnz[None, :]
                   | (leaf_capacity >= leader_per_pod[None, :])).all(
                       dim=1) & has_leader
    rem = leaf_capacity - torch.where(fits_leader[:, None],
                                      leader_per_pod[None, :], 0)
    per_dom_l = torch.where(nz[None, :], floor_div(rem, safe_req), BIG)
    swl = torch.clamp(per_dom_l.amin(dim=1), max=BIG)
    return st, swl, fits_leader.to(torch.int32)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "nvcc from the CUDA toolkit at first use")


def library_path() -> Path:
    """Where the build for the current sources, headers and flags
    lives."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"kueue_kernels_{h.hexdigest()[:16]}.so"


def ptxas_report(lib: Path) -> str:
    """What ptxas said about each kernel (registers, shared memory,
    spills) when ``lib`` was built."""
    return lib.with_suffix(".ptxas.txt").read_text()


def build() -> Path:
    """Compile every kernel source into one library with one nvcc call,
    unless these sources are already built."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    sources = sorted(CSRC.glob("*.cu"))
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on "
                f"{[p.name for p in sources]}:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.kueue_leaf_states
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fn = lib.kueue_tas_place_sequential
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 16 + [ctypes.c_longlong,
                                                   ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_tensor(name: str, t: torch.Tensor, dim: int, device,
                 dtype=torch.int32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def leaf_states(leaf_capacity, per_pod, leader_per_pod, has_leader):
    """Fused leaf pass: (st, swl, ls) [D] int32.

    CPU tensors take ``leaf_states_reference``; CUDA tensors launch the
    CUDA kernel (``has_leader`` may be a Python bool or a 0-d tensor on
    the same device; a device tensor keeps the launch free of host
    synchronisation). Anything else raises.
    """
    device = leaf_capacity.device
    if device.type == "cpu":
        return leaf_states_reference(leaf_capacity, per_pod,
                                     leader_per_pod, has_leader)
    if device.type != "cuda":
        raise ValueError(f"leaf_states: unsupported device {device}")
    _check_tensor("leaf_capacity", leaf_capacity, 2, device)
    _check_tensor("per_pod", per_pod, 1, device)
    _check_tensor("leader_per_pod", leader_per_pod, 1, device)
    D, R = leaf_capacity.shape
    if R < 1 or per_pod.shape[0] != R or leader_per_pod.shape[0] != R:
        raise ValueError(
            f"leaf_states: shapes cap {tuple(leaf_capacity.shape)}, "
            f"per_pod {tuple(per_pod.shape)}, leader "
            f"{tuple(leader_per_pod.shape)} do not agree (R >= 1)")
    flag = torch.as_tensor(has_leader, device=device).to(torch.int32)
    if flag.dim() != 0:
        raise ValueError("leaf_states: has_leader must be a scalar")
    st = torch.empty(D, dtype=torch.int32, device=device)
    swl = torch.empty(D, dtype=torch.int32, device=device)
    ls = torch.empty(D, dtype=torch.int32, device=device)
    if D == 0:
        return st, swl, ls
    fn = _library().kueue_leaf_states
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(leaf_capacity.data_ptr(), per_pod.data_ptr(),
                leader_per_pod.data_ptr(), flag.data_ptr(), D, R,
                st.data_ptr(), swl.data_ptr(), ls.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"leaf_states kernel launch failed: CUDA "
                           f"error {rc}")
    leaf_states.launches += 1
    return st, swl, ls


#: CUDA kernel launches made through ``leaf_states`` in this process
leaf_states.launches = 0


def child_offsets(parents: list[np.ndarray]) -> list[np.ndarray]:
    """Per level l >= 1, the CSR offsets of each level-(l-1) domain's
    children: domain p of level l-1 has children [off[p], off[p+1]) of
    level l. ``parents[l]`` must be nondecreasing (``build_levels``
    orders every level lexicographically) and lie in [0, D_{l-1})."""
    out = []
    for l in range(1, len(parents)):
        par, n_up = parents[l], parents[l - 1].shape[0]
        if par.size and (np.any(np.diff(par) < 0) or par[0] < 0
                         or par[-1] >= n_up):
            raise ValueError(
                f"parents[{l}] must be nondecreasing and in [0, {n_up})")
        out.append(np.searchsorted(par, np.arange(n_up + 1),
                                   side="left").astype(np.int32))
    return out


class PlacerTree:
    """A TAS domain tree as ``tas_place_sequential`` takes it: the
    per-level parent arrays (checked), their child offsets, the layout of
    the kernel's state, and the flat int32 copy the kernel reads
    (``[sizes L][parents N][cbeg N][cend N]``, cbeg/cend per domain: its
    children's range in the next level), made once per device."""

    def __init__(self, parents_np) -> None:
        self.parents = [np.ascontiguousarray(p, dtype=np.int32)
                        for p in parents_np]
        self.sizes = [p.shape[0] for p in self.parents]
        if not self.parents or min(self.sizes) < 1 or any(
                p.ndim != 1 for p in self.parents):
            raise ValueError("PlacerTree: every level needs >= 1 domain "
                             f"(sizes {self.sizes})")
        self.n_levels = len(self.sizes)
        self.n_domains = sum(self.sizes)
        self.n_leaves = self.sizes[-1]
        self.max_width = max(self.sizes)
        self.max_groups = max([1] + self.sizes[:-1])
        cbeg = np.zeros(self.n_domains, dtype=np.int32)
        cend = np.zeros(self.n_domains, dtype=np.int32)
        base = 0
        for off in child_offsets(self.parents):
            n_up = off.shape[0] - 1
            cbeg[base:base + n_up] = off[:-1]
            cend[base:base + n_up] = off[1:]
            base += n_up
        self.flat = np.concatenate([np.asarray(self.sizes, dtype=np.int32),
                                    *self.parents, cbeg, cend])
        self._device: dict[str, torch.Tensor] = {}
        self._plain: dict[str, object] = {}

    def state_words(self, R: int) -> int:
        """int32 words of the kernel's state (tas_place.cu
        ``state_words``): sizes and level bases, the [D, R] capacity
        carry, ten per-domain arrays, three of scratch per domain of the
        widest level and five per sibling group."""
        return (2 * self.n_levels + 1 + self.n_leaves * R
                + 10 * self.n_domains + 3 * self.max_width
                + 5 * self.max_groups)

    def footprint_bytes(self, R: int) -> int:
        """Shared memory the kernel needs to hold its state on chip."""
        return 4 * self.state_words(R) + PLACE_STATIC_SHARED_BYTES

    def uses_shared(self, R: int) -> bool:
        """True when the state fits in one block's shared memory; above
        227 KB the kernel runs on a global scratch buffer instead."""
        return self.footprint_bytes(R) <= SHARED_LIMIT_BYTES

    def on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._device.get(key)
        if t is None:
            t = torch.as_tensor(self.flat, device=device)
            self._device[key] = t
        return t


_PLACE_INPUTS = (  # name, dtype, dims ([D, R] / [M, R] / [M])
    ("leaf_capacity", torch.int32, 2), ("per_pod", torch.int32, 2),
    ("count", torch.int32, 1), ("level", torch.int32, 1),
    ("required", torch.bool, 1), ("unconstrained", torch.bool, 1),
    ("least_free", torch.bool, 1), ("slice_size", torch.int32, 1),
    ("slice_level", torch.int32, 1), ("leader_per_pod", torch.int32, 2),
    ("has_leader", torch.bool, 1))


def tas_place_sequential_reference(tree: PlacerTree, *inputs):
    """Plain PyTorch version: ``tas_kernels.make_sequential_placer_ext``
    on the tree with the all-PyTorch leaf pass (``leaf_states_reference``),
    so it launches no hand kernel on any device."""
    from kueue_oss_tpu_torch.solver import tas_kernels  # imports this module

    device = inputs[0].device
    placer = tree._plain.get(str(device))
    if placer is None:
        placer = tas_kernels.make_sequential_placer_ext(
            tree.parents, device, leaf_fn=leaf_states_reference)
        tree._plain[str(device)] = placer
    return placer(*inputs)


def tas_place_sequential(tree: PlacerTree, leaf_capacity, per_pod, count,
                         level, required, unconstrained, least_free,
                         slice_size, slice_level, leader_per_pod,
                         has_leader):
    """Place M podsets one after another on ``tree`` with the capacity
    carry between them: ``make_sequential_placer_ext(tree.parents,
    device)(...)`` in one kernel launch.

    Inputs: leaf_capacity [D, R], per_pod and leader_per_pod [M, R],
    count, level, slice_size and slice_level [M] int32; required,
    unconstrained, least_free and has_leader [M] bool. Returns (sels
    [M, D] int32, leads [M] int32, oks [M] bool, capacity after [D, R]
    int32). CPU tensors take ``tas_place_sequential_reference``; CUDA
    tensors launch the kernel (no host synchronisation) or raise.
    """
    inputs = (leaf_capacity, per_pod, count, level, required,
              unconstrained, least_free, slice_size, slice_level,
              leader_per_pod, has_leader)
    device = leaf_capacity.device
    if device.type == "cpu":
        return tas_place_sequential_reference(tree, *inputs)
    if device.type != "cuda":
        raise ValueError(f"tas_place_sequential: unsupported device "
                         f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("tas_place_sequential: CUDA tensors but "
                           "torch.cuda.is_available() is False")
    for t, (name, dtype, dim) in zip(inputs, _PLACE_INPUTS):
        _check_tensor(name, t, dim, device, dtype)
    D, R = leaf_capacity.shape
    M = per_pod.shape[0]
    shapes = [tuple(t.shape) for t in inputs]
    want = [(tree.n_leaves, R), (M, R)] + [(M,)] * 7 + [(M, R), (M,)]
    if R < 1 or shapes != want:
        raise ValueError(f"tas_place_sequential: input shapes {shapes} do "
                         f"not match {want} (tree of {tree.n_leaves} "
                         f"leaves, R >= 1)")
    outputs = (torch.empty((M, D), dtype=torch.int32, device=device),
               torch.empty(M, dtype=torch.int32, device=device),
               torch.empty(M, dtype=torch.bool, device=device),
               torch.empty((D, R), dtype=torch.int32, device=device))
    gstate = None if tree.uses_shared(R) else torch.empty(
        tree.state_words(R), dtype=torch.int32, device=device)
    fn = _library().kueue_tas_place_sequential
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(tree.on(device).data_ptr(), tree.n_levels, tree.n_domains,
                tree.n_leaves, tree.max_width, tree.max_groups, R, M,
                *(t.data_ptr() for t in inputs),
                *(t.data_ptr() for t in outputs),
                None if gstate is None else gstate.data_ptr(),
                tree.state_words(R), stream)
    if rc != 0:
        raise RuntimeError(f"tas_place_sequential kernel launch failed: "
                           f"CUDA error {rc}")
    tas_place_sequential.launches += 1
    tas_place_sequential.steps += M
    return outputs


#: CUDA kernel launches made through ``tas_place_sequential``, and the
#: podsets those launches placed
tas_place_sequential.launches = 0
tas_place_sequential.steps = 0
