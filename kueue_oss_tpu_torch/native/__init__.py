"""The native (C++) verify oracle, loaded through ctypes.

A copy of ``kueue_oss_tpu/native/__init__.py``: the sequential quota
re-check that ``SolverEngine.drain(verify=True)`` runs over a device
plan before it commits it (``oracle.cpp``). It is host code, not a
kernel: g++ builds it at first use into ``_build/`` beside the package,
keyed on a hash of the source and the flags (as ``solver/cuda_tas.py``
keys the nvcc build), never next to the source. Without a compiler
every call takes the pure-Python walk, the reference behaviour.

``counters`` records which path ran: native calls, Python calls, the
entries they checked, the rejections and the seconds, so that a
fallback to Python is never silent. ``reset_counters`` zeroes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.api.types import FlavorResource
from kueue_oss_tpu_torch.core.quota import QuotaNode

_SRC = Path(__file__).resolve().parent / "oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

#: per-process counts of the verify calls by path
counters = {"native_calls": 0, "python_calls": 0, "entries": 0,
            "rejections": 0, "seconds": 0.0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0.0 if k == "seconds" else 0


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"oracle_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The compiled library, building it if absent; None if
    unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        path = library_path()
        if not path.is_file() and not _compile(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.verify_plan.restype = ctypes.c_int64
        lib.verify_plan.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return _lib


class BatchOracle:
    """Flattened quota forest for batch verify-and-charge.

    Built once per drain from the snapshot's forest; ``verify_and_apply``
    checks a sequence of (cq_name, {FlavorResource: qty}) admissions in
    order, charging the ones that fit: the same as QuotaNode.fits +
    add_usage per admission, against the oracle's own flattened state.
    Neither path mutates the QuotaNode objects passed to ``__init__``;
    the charged state is ``usage``.
    """

    def __init__(self, cqs: dict[str, QuotaNode]) -> None:
        # every node reachable from the CQ leaves, parents first
        roots = []
        seen = set()
        for node in cqs.values():
            root = node.root()
            if id(root) not in seen:
                seen.add(id(root))
                roots.append(root)
        nodes: list[QuotaNode] = []
        for root in roots:
            stack = [root]
            while stack:
                n = stack.pop()
                nodes.append(n)
                stack.extend(n.children.values())
        self._nodes = nodes
        self._index = {id(n): i for i, n in enumerate(nodes)}
        self._cq_node = {name: self._index[id(n)] for name, n in cqs.items()}
        self._cqs = cqs

        frs: set[FlavorResource] = set()
        for n in nodes:
            frs.update(n.quotas)
            frs.update(n.subtree_quota)
            frs.update(n.usage)
        self._fr_list = sorted(frs)
        self._fr_index = {fr: i for i, fr in enumerate(self._fr_list)}

        N, F = len(nodes), max(1, len(self._fr_list))
        self.F = F
        self.parent = np.full(N, -1, dtype=np.int32)
        self.local_quota = np.zeros((N, F), dtype=np.int64)
        self.subtree = np.zeros((N, F), dtype=np.int64)
        self.has_borrow = np.zeros((N, F), dtype=np.uint8)
        self.borrow_limit = np.zeros((N, F), dtype=np.int64)
        self.usage = np.zeros((N, F), dtype=np.int64)
        for i, n in enumerate(nodes):
            if n.parent is not None:
                self.parent[i] = self._index[id(n.parent)]
            for fr, q in n.quotas.items():
                j = self._fr_index[fr]
                if q.borrowing_limit is not None:
                    self.has_borrow[i, j] = 1
                    self.borrow_limit[i, j] = q.borrowing_limit
            for fr, val in n.subtree_quota.items():
                self.subtree[i, self._fr_index[fr]] = val
            for fr, val in n.usage.items():
                self.usage[i, self._fr_index[fr]] = val
            for j, fr in enumerate(self._fr_list):
                self.local_quota[i, j] = n.local_quota(fr)

    def verify_and_apply(
        self, admissions: list[tuple[str, dict[FlavorResource, int]]],
        force_python: bool = False,
    ) -> np.ndarray:
        """ok[i] per admission; fitting admissions charge usage in
        order."""
        t0 = time.perf_counter()
        ok = np.zeros(len(admissions), dtype=np.uint8)
        lib = None if force_python else load()
        if lib is None:
            counters["python_calls"] += 1
            self._python_verify(admissions, ok)
        else:
            counters["native_calls"] += 1
            self._native_verify(lib, admissions, ok)
        counters["entries"] += len(admissions)
        counters["rejections"] += int(len(admissions) - int(ok.sum()))
        counters["seconds"] += time.perf_counter() - t0
        return ok

    def _native_verify(self, lib, admissions, ok: np.ndarray) -> None:
        # An admission naming a (flavor, resource) with no quota anywhere
        # can never fit (available() over an unknown fr is <= 0), and a
        # CQ absent from the forest (deleted since the plan was made)
        # cannot be charged: both are rejected up front instead of being
        # indexed into the CSR arrays, as _python_verify does.
        valid = [i for i, (cq_name, usage) in enumerate(admissions)
                 if cq_name in self._cq_node
                 and all(q <= 0 or fr in self._fr_index
                         for fr, q in usage.items())]
        node_idx = np.zeros(len(valid), dtype=np.int32)
        ptr = np.zeros(len(valid) + 1, dtype=np.int64)
        fr_l: list[int] = []
        qty_l: list[int] = []
        for j, i in enumerate(valid):
            cq_name, usage = admissions[i]
            node_idx[j] = self._cq_node[cq_name]
            for fr, q in usage.items():
                if q <= 0:
                    continue
                fr_l.append(self._fr_index[fr])
                qty_l.append(q)
            ptr[j + 1] = len(fr_l)
        ok_valid = np.zeros(len(valid), dtype=np.uint8)
        lib.verify_plan(
            np.int32(len(self._nodes)), np.int32(self.F),
            self.parent, self.local_quota.ravel(), self.subtree.ravel(),
            self.has_borrow.ravel(), self.borrow_limit.ravel(),
            self.usage.ravel(),
            np.int64(len(valid)), node_idx, ptr,
            np.asarray(fr_l, dtype=np.int32),
            np.asarray(qty_l, dtype=np.int64), ok_valid)
        ok[valid] = ok_valid

    def _python_verify(self, admissions, ok: np.ndarray) -> np.ndarray:
        """Pure-Python mirror of oracle.cpp verify_plan over the same
        flattened arrays; it charges only the oracle's own state."""
        for i, (cq_name, usage) in enumerate(admissions):
            n = self._cq_node.get(cq_name)
            if n is None:
                continue
            items = [(self._fr_index[fr], q) for fr, q in usage.items()
                     if q > 0 and fr in self._fr_index]
            if any(q > 0 and fr not in self._fr_index
                   for fr, q in usage.items()):
                continue  # an unknown fr never fits (available() <= 0)
            if all(q <= self._available(n, j) for j, q in items):
                ok[i] = 1
                for j, q in items:
                    self._add_usage(n, j, q)
        return ok

    def _available(self, n: int, f: int) -> int:
        """QuotaNode.available over the flattened arrays
        (resource_node.go:104-118)."""
        if self.parent[n] < 0:
            return int(self.subtree[n, f] - self.usage[n, f])
        parent_avail = self._available(int(self.parent[n]), f)
        if self.has_borrow[n, f]:
            stored_in_parent = int(self.subtree[n, f]
                                   - self.local_quota[n, f])
            used_in_parent = max(
                0, int(self.usage[n, f] - self.local_quota[n, f]))
            with_max = (stored_in_parent - used_in_parent
                        + int(self.borrow_limit[n, f]))
            parent_avail = min(with_max, parent_avail)
        local_avail = max(0, int(self.local_quota[n, f] - self.usage[n, f]))
        return local_avail + parent_avail

    def _add_usage(self, n: int, f: int, val: int) -> None:
        """QuotaNode.add_usage bubbling (resource_node.go:137-146)."""
        while True:
            local_avail = max(
                0, int(self.local_quota[n, f] - self.usage[n, f]))
            self.usage[n, f] += val
            p = int(self.parent[n])
            if p < 0 or val <= local_avail:
                return
            val -= local_avail
            n = p
