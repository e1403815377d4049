"""Scenario-resident device state for repeated what-if sweeps.

A copy of ``kueue_oss_tpu/sim/resident.py``. A planning surface asks
the same store many questions: sweep, tweak a knob, sweep again.
Without residency every sweep pays a full export + host_tensors_full +
device upload of the padded base problem even when nothing moved. A
:class:`ResidentSweep` session keeps the base export's padded FULL
tensors on the device across sweeps and syncs them against the live
store by tier:

- **spec change** (``ExportCache.spec_gen`` moved, or any padded shape
  or dtype changed): the resident state is invalid — full upload.
- **workload churn only** (spec_gen equal): diff the [W+1] workload
  rows against the previous host copy and write ONLY the dirty rows
  into the resident tensors in place (``index_copy_``); the handful of
  small workload-derived aggregates (``usage0``, AFS penalties, the
  rank bases) re-upload whole — they are KB against the row tensors'
  MB.
- **nothing moved**: reuse the resident tensors as they are.

The JAX session writes the rows with donated ``.at[rows].set``
scatters; PyTorch writes in place. A row write takes an int64 index of
unique rows and values of exactly the buffer's dtype; anything else
raises, and a failed write heals through a full upload, counted in
``scatter_faults``. Every upload copies (``torch.tensor``), so a
resident tensor never shares memory with the host copy the next diff
reads. The sync kind is counted on the session (the JAX session also
counts it in a metric; the port has no metrics layer). Steady-state
sweep cost is overlays + solve, not upload + solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.full_kernels import (
    FULL_WL_FIELDS,
    FullTensors,
    host_tensors_full,
)
from kueue_oss_tpu_torch.solver.tensors import (
    ExportCache,
    SolverProblem,
    export_problem,
    pad_workloads,
    pow2,
)

#: small workload-DERIVED aggregates that change on churn without a
#: spec_gen bump (admitted usage rollup, AFS penalty state, eviction /
#: admission rank bases, class vocabulary roots): always re-uploaded on
#: a scatter sync — KB against the row tensors
_CHEAP_FIELDS = ("usage0", "lq_penalty0", "class_root",
                 "ts_evict_base", "admit_rank_base")

#: pure-spec fields (cohort tree, CQ policy, flavor metadata): with an
#: unmoved spec_gen these MUST be unchanged; a mismatch is a missed
#: invalidation and heals through a full upload
_SPEC_FIELDS = tuple(f for f in FullTensors._fields
                     if f not in FULL_WL_FIELDS
                     and f not in _CHEAP_FIELDS)


class ResidentSweep:
    """Keeps one store's padded FULL tensors on ``device`` (``"cuda"`` by
    default; raises without CUDA) across sweeps."""

    def __init__(self, store, include_admitted: bool = True,
                 device="cuda") -> None:
        self.store = store
        self.include_admitted = include_admitted
        self.device = resolve_device(device)
        #: subscribed: spec edits bump spec_gen before the next refresh
        self.cache = ExportCache(store, subscribe=True)
        self._spec_gen: Optional[int] = None
        self._host: Optional[FullTensors] = None
        self._dev: Optional[FullTensors] = None
        # session counters (the evidence surface)
        self.full_uploads = 0
        self.scatter_refreshes = 0
        self.reuses = 0
        self.scattered_rows = 0
        #: row writes that failed and healed through a full upload
        self.scatter_faults = 0
        #: bytes NOT shipped because residency allowed scatter/reuse
        self.avoided_upload_bytes = 0
        #: real (pre-padding) workload count of the last refresh
        self.last_real_workloads = 0
        #: the sync kind of the last refresh ("full" / "scatter" /
        #: "reuse")
        self.last_sync: Optional[str] = None

    # -- byte accounting ---------------------------------------------------

    @staticmethod
    def _nbytes(t) -> int:
        """Bytes of host arrays or device tensors."""
        return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
                   else np.asarray(a).nbytes for a in t)

    def resident_bytes(self) -> int:
        return self._nbytes(self._dev) if self._dev is not None else 0

    # -- the session entry -------------------------------------------------

    def refresh(self, pending=None, now: float = 0.0,
                ) -> tuple[SolverProblem, FullTensors]:
        """Export against the live store and sync the resident tensors.

        Returns ``(padded problem, device FullTensors)`` — the pair the
        batch layer needs (``solve_scenarios_full(..., tensors=dev)``).
        The export itself stays incremental through the shared
        subscribed ExportCache."""
        from kueue_oss_tpu_torch.sim.engine import pending_backlog

        if pending is None:
            pending = pending_backlog(self.store)
        problem = export_problem(
            self.store, pending, include_admitted=self.include_admitted,
            now=now, cache=self.cache)
        self.last_real_workloads = problem.n_workloads
        problem = pad_workloads(problem,
                                pow2(max(1, problem.n_workloads)))
        host = host_tensors_full(problem)
        self.last_sync = self._sync(host, self.cache.spec_gen)
        self._spec_gen = self.cache.spec_gen
        self._host = host
        return problem, self._dev

    # -- sync tiers --------------------------------------------------------

    def _upload(self, arr) -> torch.Tensor:
        """A copy of a host array on the device (never an alias)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def _full_upload(self, host: FullTensors) -> str:
        self._dev = FullTensors(*(self._upload(a) for a in host))
        self.full_uploads += 1
        return "full"

    def _shapes_match(self, host: FullTensors) -> bool:
        return all(
            np.asarray(a).shape == np.asarray(b).shape
            and np.asarray(a).dtype == np.asarray(b).dtype
            for a, b in zip(self._host, host))

    def _sync(self, host: FullTensors, gen: int) -> str:
        if (self._dev is None or gen != self._spec_gen
                or not self._shapes_match(host)):
            return self._full_upload(host)
        for f in _SPEC_FIELDS:
            if not np.array_equal(np.asarray(getattr(self._host, f)),
                                  np.asarray(getattr(host, f))):
                # missed invalidation (spec_gen did not move but a spec
                # table did) — never trust the resident copy over truth
                return self._full_upload(host)
        dirty_fields = {}
        W1 = np.asarray(host.wl_cqid).shape[0]
        changed = np.zeros(W1, dtype=bool)
        for f in FULL_WL_FIELDS:
            a = np.asarray(getattr(self._host, f))
            b = np.asarray(getattr(host, f))
            neq = a != b
            rows = neq.reshape(W1, -1).any(axis=1) if neq.ndim > 1 else neq
            if rows.any():
                dirty_fields[f] = b
                changed |= rows
        cheap_same = all(
            np.array_equal(np.asarray(getattr(self._host, f)),
                           np.asarray(getattr(host, f)))
            for f in _CHEAP_FIELDS)
        if not dirty_fields and cheap_same:
            self.reuses += 1
            self.avoided_upload_bytes += self._nbytes(host)
            return "reuse"
        idx = np.nonzero(changed)[0].astype(np.int64)
        try:
            for f, b in dirty_fields.items():
                self._write_rows(getattr(self._dev, f), idx, b[idx])
        except (TypeError, ValueError, RuntimeError):
            # a partly applied write leaves the buffers half updated:
            # heal through a fresh full upload
            self.scatter_faults += 1
            return self._full_upload(host)
        shipped = sum(int(idx.nbytes) + int(b[idx].nbytes)
                      for b in dirty_fields.values())
        updates = {}
        for f in _CHEAP_FIELDS:
            arr = np.asarray(getattr(host, f))
            updates[f] = self._upload(arr)
            shipped += int(arr.nbytes)
        self._dev = self._dev._replace(**updates)
        self.scatter_refreshes += 1
        self.scattered_rows += int(idx.size)
        self.avoided_upload_bytes += max(0, self._nbytes(host) - shipped)
        return "scatter"

    def _write_rows(self, buf: torch.Tensor, idx: np.ndarray,
                    vals: np.ndarray) -> None:
        """``buf[idx] = vals`` in place: an int64 index of unique rows
        (a repeated row makes ``index_copy_`` nondeterministic on CUDA)
        and values of exactly the buffer's dtype."""
        src = torch.tensor(np.ascontiguousarray(vals))
        if src.dtype != buf.dtype:
            raise TypeError(f"row write of dtype {src.dtype} for a "
                            f"{buf.dtype} buffer")
        if (idx.dtype != np.int64 or idx.ndim != 1
                or tuple(src.shape) != (idx.size,) + tuple(buf.shape[1:])
                or np.unique(idx).size != idx.size):
            raise ValueError(f"row write {idx.shape} / {tuple(src.shape)} "
                             f"does not address unique rows of "
                             f"{tuple(buf.shape)}")
        buf.index_copy_(0, torch.tensor(idx, device=buf.device),
                        src.to(buf.device))

    def stats(self) -> dict:
        return {
            "full_uploads": self.full_uploads,
            "scatter_refreshes": self.scatter_refreshes,
            "reuses": self.reuses,
            "scattered_rows": self.scattered_rows,
            "scatter_faults": self.scatter_faults,
            "avoided_upload_bytes": self.avoided_upload_bytes,
            "resident_bytes": self.resident_bytes(),
        }
