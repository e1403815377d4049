"""The single-process device mesh: detection, placement and collectives.

Port of ``kueue_oss_tpu/solver/meshutil.py`` (:186-335). The JAX
package's in-process mesh is a 1-D ``jax.sharding.Mesh`` over local
devices, and its sharded drains are ``shard_map`` programs with explicit
``pmin`` / ``psum`` collectives. The port's counterpart:

- a ``Mesh`` is an ordered tuple of ``torch.device``s on the 1-D ``wl``
  axis; shard s owns the s-th block of the (padded) workload axis;
- ``MeshTensors`` holds a problem's tensors placed on a mesh: every
  workload-axis field is block-sharded (shard s's rows are their own
  tensors on ``devices[s]``), every other field is replicated, one copy
  per shard's device;
- ``pmin``, ``psum`` and ``all_gather`` reduce per-shard tensors (one
  per shard, in shard order) onto each shard's device without a host
  read, through the mesh's ``Collectives`` backend.
  ``LocalCollectives`` (one process) reduces in shard order; a
  ``torch.distributed`` process-group backend plugs in behind the same
  interface without touching ``sharded.py``.

``detect_mesh`` follows the JAX mode grammar (``parse_mesh_mode``):
CUDA devices are counted with ``torch.cuda.device_count()`` and the CPU
counts as one device, as JAX's CPU backend does without its virtual
device flag. ``set_virtual_devices(n)`` is the counterpart of XLA's
``--xla_force_host_platform_device_count``: process-wide, it makes the
first local device appear n times (tests hold the JAX conftest's 8
devices with it; ``chip_smoke.py`` a 4-shard mesh on one card). No
entry point of the program calls it.

Cut from the copy: the multi-process pod mesh (``bootstrap_distributed``,
``parse_coordinator``, a cross-process ``host_replicated``), ROADMAP
Queue A item 9b. ``host_replicated`` is the identity here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

#: process-wide virtual device count (0 = the real devices)
_virtual = {"n": 0}


def set_virtual_devices(n: int) -> None:
    """Make the first local device appear ``n`` times to ``detect_mesh``
    (0 restores the real device count). Process-wide, like XLA's
    ``--xla_force_host_platform_device_count``."""
    if int(n) < 0:
        raise ValueError(f"virtual device count {n} < 0")
    _virtual["n"] = int(n)


def local_devices(device="cuda") -> list[torch.device]:
    """The local devices of ``device``'s platform: every CUDA device, or
    the CPU as one device; the first of them repeated when virtual
    devices are set."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        found = [torch.device("cuda", i) for i in range(n)]
    elif dev.type == "cpu":
        found = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device {device!r}")
    if _virtual["n"] and found:
        return [found[0]] * _virtual["n"]
    return found


class Collectives:
    """The mesh's collectives over per-shard tensors (one per shard, in
    shard order). Each returns one result per shard, on that shard's
    device."""

    def pmin(self, mesh: "Mesh", parts: Sequence[torch.Tensor]) -> list:
        raise NotImplementedError

    def psum(self, mesh: "Mesh", parts: Sequence[torch.Tensor]) -> list:
        raise NotImplementedError

    def all_gather(self, mesh: "Mesh", parts: Sequence[torch.Tensor],
                   dim: int = 0) -> list:
        raise NotImplementedError


class LocalCollectives(Collectives):
    """One process holds every shard: each collective reduces the parts
    in shard order on the first shard's device (((p0 op p1) op p2) ...),
    then places the result on each shard's device (a no-op where the
    devices coincide). No host read."""

    @staticmethod
    def _fold(mesh: "Mesh", parts, op) -> torch.Tensor:
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{mesh.size} shards")
        lead = mesh.devices[0]
        acc = parts[0].to(lead)
        for p in parts[1:]:
            acc = op(acc, p.to(lead))
        return acc

    @staticmethod
    def _spread(mesh: "Mesh", value: torch.Tensor) -> list:
        return [value.to(d) for d in mesh.devices]

    def pmin(self, mesh, parts):
        return self._spread(mesh, self._fold(mesh, parts, torch.minimum))

    def psum(self, mesh, parts):
        return self._spread(mesh, self._fold(mesh, parts, torch.add))

    def all_gather(self, mesh, parts, dim: int = 0):
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{mesh.size} shards")
        lead = mesh.devices[0]
        return self._spread(mesh, torch.cat([p.to(lead) for p in parts],
                                            dim=dim))


LOCAL = LocalCollectives()


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in shard order on the workload axis.
    Hashable (a cache key, as JAX's ``Mesh``); the collectives backend
    is not part of its identity."""

    devices: tuple
    collectives: Collectives = field(default=LOCAL, compare=False,
                                     repr=False)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The first shard's device: where replicated steps run once."""
        return self.devices[0]


def pmin(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list:
    return mesh.collectives.pmin(mesh, parts)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list:
    return mesh.collectives.psum(mesh, parts)


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor],
               dim: int = 0) -> list:
    """The shards' blocks joined in shard order along ``dim``."""
    return mesh.collectives.all_gather(mesh, parts, dim)


def broadcast(mesh: Mesh, value: torch.Tensor) -> list:
    """A replicated value (computed once on the lead) on every shard's
    device."""
    return [value.to(d) for d in mesh.devices]


class MeshTensors:
    """A NamedTuple of tensors placed on a mesh. ``shards[s]`` is a
    NamedTuple of the same type whose ``row_fields`` hold shard s's
    block of rows and whose other fields are replicated copies, every
    tensor on ``mesh.devices[s]``."""

    def __init__(self, mesh: Mesh, shards: list, row_fields) -> None:
        self.mesh = mesh
        self.shards = shards
        self.row_fields = frozenset(row_fields)
        self.kind = type(shards[0])

    @property
    def _fields(self) -> tuple:
        return self.kind._fields

    @property
    def block(self) -> int:
        """Rows per shard."""
        return int(getattr(self.shards[0], next(iter(
            f for f in self._fields if f in self.row_fields))).shape[0])

    @property
    def rows(self) -> int:
        return self.block * self.mesh.size

    def __iter__(self):
        for sh in self.shards:
            yield from sh

    def field(self, name: str) -> list:
        """The field's tensor on every shard."""
        return [getattr(sh, name) for sh in self.shards]

    def gather(self):
        """The whole problem on the lead device: each row field joined
        through ``all_gather``, the replicated fields from shard 0."""
        return self.kind(**{
            f: (all_gather(self.mesh, self.field(f))[0]
                if f in self.row_fields else getattr(self.shards[0], f))
            for f in self._fields})


def place(host: NamedTuple, mesh: Mesh, row_fields) -> MeshTensors:
    """Place host (numpy) arrays on ``mesh``: row fields block-sharded,
    the rest replicated; every tensor a copy. The row count must divide
    by the mesh width (``align_pad_target``)."""
    rows = {f for f in host._fields if f in row_fields}
    w1 = int(np.asarray(getattr(host, next(iter(rows)))).shape[0])
    n = mesh.size
    if w1 % n != 0:
        raise ValueError(
            f"workload axis of {w1} rows does not shard over {n} "
            "devices; pad with meshutil.align_pad_target first")
    b = w1 // n
    shards = []
    for s, dev in enumerate(mesh.devices):
        shards.append(type(host)(**{
            f: torch.tensor(np.asarray(a)[s * b:(s + 1) * b]
                            if f in rows else np.asarray(a), device=dev)
            for f, a in zip(host._fields, host)}))
    return MeshTensors(mesh, shards, rows)


def host_replicated(arrays) -> tuple:
    """The outputs as host numpy arrays (one process: the identity)."""
    return tuple(a.cpu().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in arrays)


def parse_mesh_mode(mode: Optional[str]) -> Optional[int]:
    """Normalize a mesh mode string to a device-count request.

    Returns None for "off", -1 for "auto" (all devices), or a positive
    explicit device count. Unknown strings FAIL CLOSED (off): a typo-ed
    env var intended to disable the multi-device path must never enable
    it (config-file values are additionally validated at load).
    """
    if mode is None:
        import os

        mode = os.environ.get("KUEUE_SOLVER_MESH") or "auto"
    mode = str(mode).strip().lower()
    if mode in ("auto", "on", "true", ""):
        return -1
    try:
        n = int(mode)
    except ValueError:
        return None  # "off"/"none"/"disabled"/typos: all off
    return n if n > 1 else None


def detect_mesh(mode: Optional[str] = None, max_devices: int = 0,
                device="cuda") -> Optional[Mesh]:
    """Build the 1-D ``wl`` mesh the mode asks for over ``device``'s
    platform, or None.

    An explicit device count requires at least that many local devices:
    fewer yields no mesh (fail closed), never a silently narrower one.
    ``max_devices`` (when > 0) caps the width, as a lost device shrinks
    the usable slice (the chaos harness's mesh shrink).
    """
    want = parse_mesh_mode(mode)
    if want is None:
        return None
    devices = local_devices(device)
    if want < 0:
        n = len(devices)
    elif want > len(devices):
        return None
    else:
        n = want
    if max_devices > 0:
        n = min(n, max_devices)
    if n < 2:
        return None
    return Mesh(tuple(devices[:n]))


def mesh_devices(mesh) -> int:
    return int(mesh.size) if mesh is not None else 0


def mesh_divisible(mesh, w1: int) -> bool:
    """Whether a [W+1]-row workload axis block-shards evenly."""
    return mesh is not None and w1 % mesh_devices(mesh) == 0


def align_pad_target(target_w: int, mesh_devices: int = 0,
                     extra_width: int = 0) -> int:
    """Grow a pad target so the padded axis (``target_w`` + the null
    row) splits evenly over a mesh of ``mesh_devices`` devices, and over
    ``extra_width`` when given (a remote sidecar's advertised mesh; lcm
    covers both). The same widths always give the same alignment, so
    session slot coordinates stay stable across drains."""
    widths = [w for w in (int(mesh_devices), int(extra_width)) if w > 1]
    if not widths:
        return target_w
    m = math.lcm(*widths)
    return target_w + (-(target_w + 1)) % m


def live_rows(wl_cqid, n_cqs: int) -> int:
    """Real (non-padding, non-null, non-recycled) workload rows in a
    padded export: the count the mesh floors gate on (engine routing,
    resident placement and the sidecar share it)."""
    return int((np.asarray(wl_cqid[:-1]) < n_cqs).sum())


def shard_imbalance(wl_cqid, n_cqs: int, mesh) -> float:
    """Real-row imbalance across shards: (max - min) / mean occupied
    rows per shard (0.0 = perfectly even). Padding and recycled session
    slots count as empty."""
    n = mesh_devices(mesh)
    if n < 2:
        return 0.0
    occ = np.asarray(wl_cqid) < n_cqs
    if occ.shape[0] % n != 0:
        return 0.0
    per = occ.reshape(n, -1).sum(axis=1).astype(np.float64)
    mean = float(per.mean())
    if mean <= 0:
        return 0.0
    return float((per.max() - per.min()) / mean)


#: lean mesh drains keyed by mesh
_lean_cache: dict = {}


def lean_mesh_solver(mesh: Mesh):
    """The cached lean mesh drain for ``mesh``: the whole solve_backlog
    contract (admitted, opt, admit_round, parked, rounds, usage),
    bit-identical to the single-device drain."""
    fn = _lean_cache.get(mesh)
    if fn is None:
        from kueue_oss_tpu_torch.solver.sharded import make_sharded_drain

        fn = make_sharded_drain(mesh)
        _lean_cache[mesh] = fn
    return fn


#: mesh-sharded relaxed LPs keyed by (mesh, iters)
_relax_cache: dict = {}


def relax_mesh_lp(mesh: Mesh, iters: int):
    """The cached mesh-sharded projected-gradient LP of the relaxed arm
    (solver/relax.py; body in sharded.make_sharded_relax_lp)."""
    key = (mesh, int(iters))
    fn = _relax_cache.get(key)
    if fn is None:
        from kueue_oss_tpu_torch.solver.sharded import make_sharded_relax_lp

        fn = make_sharded_relax_lp(mesh, int(iters))
        _relax_cache[key] = fn
    return fn
