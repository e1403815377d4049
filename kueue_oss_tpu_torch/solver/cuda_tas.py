"""The TAS leaf-state pass: CUDA kernel + plain PyTorch version.

Counterpart of ``kueue_oss_tpu/solver/pallas_tas.py``. The fused
phase-1 leaf pass of TAS placement (fillInCounts'
leaf block, tas_flavor_snapshot.go:1568) computes, for every leaf
domain, how many pods fit (``st``), whether the leader fits (``ls``) and
how many pods fit beside the leader (``swl``).

- ``leaf_states`` launches the CUDA kernel ``csrc/leaf_states.cu`` for a
  CUDA tensor (it launches or raises, never falls back) and takes the
  plain version only for CPU tensors. ``leaf_states.launches`` counts
  kernel launches.
- ``leaf_states_reference`` is the plain version, a line-for-line port
  of ``pallas_tas.leaf_states_reference``: the CPU path and the oracle
  the kernel is held against on the card.

The kernel replaces the Pallas TPU kernel ``_leaf_states_kernel``
(pallas_tas.py:53-121). The source note in ``csrc/leaf_states.cu`` gives
its bound (launch-bound at the drain's 640-leaf shapes) and design (one
thread per leaf row, a loop over R, floor division, a device-resident
``has_leader`` flag).

The library is compiled with ``nvcc`` at first use into ``_build/``
beside the package, keyed on a hash of the source and flags, and bound
with ``ctypes`` (no PyTorch headers, so the build takes seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from kueue_oss_tpu_torch.solver.ops import floor_div

BIG = 1 << 30

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "leaf_states.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

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
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"leaf_states_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                f"{proc.stdout}{proc.stderr}")
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
        _lib = lib
    return _lib


def _check_int32(name: str, t: torch.Tensor, dim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
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
    _check_int32("leaf_capacity", leaf_capacity, 2, device)
    _check_int32("per_pod", per_pod, 1, device)
    _check_int32("leader_per_pod", leader_per_pod, 1, device)
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
