"""Federated control-plane fleet helpers.

A copy of ``kueue_oss_tpu/federation/fleet.py``. A *member* is one
complete control plane — Store, QueueManager, Scheduler, SolverEngine —
whose engine talks to a SHARED solver farm through a tenant-tagged
``SolverClient``. N members against one sidecar is the "many clusters,
one brain" topology; these helpers build that wiring for tests,
chip_smoke.py's federation phase and the chaos member-loss harness.

The per-member plan contract: because the farm namespaces sessions by
tenant and the DRR only reorders WHO solves next (never what a solve
returns), a member's admitted/parked plans must be bit-identical to
the same control plane running against a dedicated sidecar —
``plan_fingerprint`` is the equality the tests assert.

Each member's engine lives on ``device`` ("cuda" unless the caller asks
for the CPU; it raises without CUDA): a remote member exports, verifies,
places TAS podsets and commits there, a member without a socket also
solves there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
from kueue_oss_tpu_torch.solver.engine import SolverEngine
from kueue_oss_tpu_torch.solver.service import SolverClient


@dataclasses.dataclass
class FederationMember:
    """One tenant control plane bound to the shared farm."""

    name: str
    store: Store
    queues: QueueManager
    scheduler: Scheduler
    engine: SolverEngine

    def drain(self, now: float = 0.0):
        return self.engine.drain(now=now)


def build_member(name: str,
                 socket_path: Optional[str] = None,
                 store: Optional[Store] = None,
                 seed: Optional[Callable[[Store], None]] = None,
                 pad_to: Optional[int] = None,
                 device="cuda",
                 **client_kwargs) -> FederationMember:
    """Build one control plane. With ``socket_path`` the engine solves
    remotely as tenant ``name``; without it the member solves in-process
    (the dedicated-baseline twin in parity tests). ``seed`` populates
    the (fresh or supplied) store before the queue manager attaches."""
    store = store if store is not None else Store()
    if seed is not None:
        seed(store)
    queues = QueueManager(store)
    scheduler = Scheduler(store, queues, device=device)
    remote = (SolverClient(socket_path, tenant=name, **client_kwargs)
              if socket_path is not None else None)
    engine = SolverEngine(store, queues, device=device, scheduler=scheduler,
                          remote=remote)
    if pad_to is not None:
        engine.pad_to = pad_to
    return FederationMember(name=name, store=store, queues=queues,
                            scheduler=scheduler, engine=engine)


def build_fleet(names, socket_path: Optional[str] = None,
                seed: Optional[Callable[[str, Store], None]] = None,
                pad_to: Optional[int] = None,
                device="cuda",
                **client_kwargs) -> dict[str, FederationMember]:
    """N members sharing one farm socket; ``seed(name, store)`` lets
    each tenant start from its own (usually identical) cluster shape."""
    return {name: build_member(
        name, socket_path=socket_path,
        seed=(lambda s, _n=name: seed(_n, s)) if seed is not None
        else None,
        pad_to=pad_to, device=device, **client_kwargs) for name in names}


def plan_fingerprint(store: Store,
                     queues: Optional[QueueManager] = None) -> tuple:
    """The bit-identity surface for farm-vs-dedicated parity: which
    workloads hold quota (admitted) and which sit parked in their
    queues' inadmissible sets. Two control planes that ran the same
    churn agree on their plans iff these tuples are equal."""
    admitted = tuple(sorted(
        k for k, w in store.workloads.items()
        if w.is_quota_reserved and not w.is_finished))
    parked = ()
    if queues is not None:
        parked = tuple(sorted(
            k for q in queues.queues.values()
            for k in q.inadmissible if k not in q._stale))
    return admitted, parked
