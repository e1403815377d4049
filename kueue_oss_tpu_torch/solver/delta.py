"""Delta sessions: stable row encodings, problem deltas, and resident
device state.

Port of ``kueue_oss_tpu/solver/delta.py``. Successive drains of one
kind (lean or FULL) re-encode the padded export so that a churn cycle
changes only the rows whose workloads changed:

- ``HostDeltaSession`` re-encodes each padded export into a **stable
  slot space** (a workload keeps its row for the life of the session;
  freed rows are recycled as inert padding) with **order-preserving
  stable ranks** for timestamps and admit ranks and **stable class
  tokens**, instead of dense ranks that shift wholesale when an early
  workload leaves.
- ``compute_delta``/``apply_delta`` diff two consecutive encodings into
  a ``ProblemDelta`` (changed rows + small-array replacements + scalar
  meta updates) and replay it bit-identically.
- ``state_checksum`` is the content checksum of an encoding.
- ``DeviceResidentProblem`` keeps the padded problem tensors on the
  device across drains and writes only a delta's dirty rows.

The delta is *content-based*: it compares the encoded arrays, and the
``ExportCache`` dirty sets are statistics and fast-path hints only, so a
delta-applied state is bit-identical to a fresh full sync. What a delta
cannot express cheaply (shape growth, scale flips, renumbers, more than
half the rows dirty) degrades to a full sync.

Cut from the copy: the remote sidecar and its wire protocol
(``serialize_delta`` / ``deserialize_delta``: the port has no
``service.py`` yet), and mesh placement of the resident tensors.
``set_interleave`` is kept for the multi-device port; the engine calls
it with 1.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.solver.tensors import (
    BIG,
    TIMESTAMP_PREEMPTION_BUFFER_S,
    SolverProblem,
    pow2,
)

#: SolverProblem fields that ride the wire as arrays. Host-only decode
#: tables (fr_list, wl_keys, ...) and the raw stable-encoding inputs
#: (wl_raw_ts, ...) stay on the host.
HOST_ONLY_FIELDS = (
    "fr_list", "node_names", "cq_names", "wl_keys", "cq_option_flavors",
    "cq_resource_group", "scale", "n_resources", "ts_evict_base",
    "admit_rank_base", "n_classes",
    "wl_raw_ts", "wl_raw_admit_ts", "wl_class_tok", "class_tok_root",
)
ARRAY_FIELDS = [
    f.name for f in dataclasses.fields(SolverProblem)
    if f.name not in HOST_ONLY_FIELDS
]
META_FIELDS = ["n_resources", "ts_evict_base", "admit_rank_base", "scale"]

#: workload-axis arrays ([W+1] leading dim): delta'd row-wise
W_AXIS_FIELDS = (
    "wl_cqid", "wl_rank", "wl_prio", "wl_ts", "wl_uid", "wl_req",
    "wl_valid", "wl_parked0", "wl_admitted0", "wl_evicted0",
    "wl_admit_rank", "ad_usage", "wl_class", "wl_lq", "wl_afs_penalty",
    "wl_ts_buf",
)
NON_W_FIELDS = tuple(f for f in ARRAY_FIELDS if f not in W_AXIS_FIELDS)

#: a delta dirtying more than this fraction of rows costs more than a
#: full sync saves; degrade (counted as reason="dense_delta")
DENSE_DELTA_FRACTION = 0.5


# ---------------------------------------------------------------------------
# content checksum
# ---------------------------------------------------------------------------


def state_checksum(kwargs: dict, meta: dict) -> int:
    """Cheap content checksum over the wire-visible problem state.

    crc32 chained over every present array's (name, dtype, shape,
    bytes) in canonical field order plus the meta scalars — both sides
    compute it over their own state after every sync/delta, so any
    divergence (a garbled frame that still decoded, an apply bug, a
    version skew) is caught before the next plan is trusted.
    """
    crc = 0
    for name in ARRAY_FIELDS:
        arr = kwargs.get(name)
        if arr is None:
            continue
        arr = np.ascontiguousarray(arr)
        head = f"{name}|{arr.dtype.str}|{arr.shape}".encode()
        crc = zlib.crc32(head, crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    crc = zlib.crc32(json.dumps(
        {k: int(meta[k]) for k in META_FIELDS}, sort_keys=True).encode(),
        crc)
    return crc & 0xFFFFFFFF


def problem_wire_state(problem: SolverProblem) -> tuple[dict, dict]:
    """Split a problem into (array kwargs, meta) in wire form."""
    kwargs = {name: getattr(problem, name) for name in ARRAY_FIELDS}
    meta = {name: int(getattr(problem, name)) for name in META_FIELDS}
    return kwargs, meta


# ---------------------------------------------------------------------------
# ProblemDelta
# ---------------------------------------------------------------------------


@dataclass
class ProblemDelta:
    """Row-sparse diff between two consecutive session epochs."""

    epoch: int
    base_epoch: int
    #: checksum of the FULL post-apply state (not of the delta)
    checksum: int
    #: per W-axis array: (dirty row indices, new content at those rows).
    #: Per-array rows, not a union: one widely-dirty one-byte flag array
    #: (parked bits toggling as capacity-freed wakes ripple) must not
    #: drag every other array's bytes along with it.
    row_updates: dict[str, tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    #: full replacements for changed non-workload arrays (node/CQ axes
    #: are small; usage/quota updates ride here)
    repl: dict[str, np.ndarray] = field(default_factory=dict)
    #: changed meta scalars (ts_evict_base and friends)
    meta_delta: dict[str, int] = field(default_factory=dict)
    #: emit statistics (dirty workloads/CQs seen, removed keys, ...)
    stats: dict = field(default_factory=dict)

    def payload_bytes(self) -> int:
        n = 0
        for idx, vals in self.row_updates.values():
            n += idx.nbytes + vals.nbytes
        for arr in self.repl.values():
            n += arr.nbytes
        return n


def compute_delta(prev_kwargs: dict, prev_meta: dict,
                  new_kwargs: dict, new_meta: dict,
                  epoch: int, base_epoch: int,
                  checksum: int) -> Optional[ProblemDelta]:
    """Diff two wire states; None means "too different — full sync".

    Incompatible = any array appearing/disappearing, any shape change
    (covers pad growth, vocabulary growth, class-space growth), a scale
    or resource-vocabulary flip (column meaning changes wholesale), or
    a dirty-row fraction above DENSE_DELTA_FRACTION.
    """
    for name in ARRAY_FIELDS:
        a, b = prev_kwargs.get(name), new_kwargs.get(name)
        if (a is None) != (b is None):
            return None
        if a is not None and (a.shape != b.shape or a.dtype != b.dtype):
            return None
    if (prev_meta["scale"] != new_meta["scale"]
            or prev_meta["n_resources"] != new_meta["n_resources"]):
        return None

    W1 = new_kwargs["wl_cqid"].shape[0]
    mask = np.zeros(W1, dtype=bool)
    row_updates: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for name in W_AXIS_FIELDS:
        a, b = prev_kwargs.get(name), new_kwargs.get(name)
        if a is None:
            continue
        neq = a != b
        if neq.ndim > 1:
            neq = neq.reshape(W1, -1).any(axis=1)
        if neq.any():
            idx = np.nonzero(neq)[0].astype(np.int32)
            row_updates[name] = (idx, np.ascontiguousarray(b[idx]))
            mask |= neq
    if int(mask.sum()) > W1 * DENSE_DELTA_FRACTION:
        return None
    repl = {}
    for name in NON_W_FIELDS:
        a, b = prev_kwargs.get(name), new_kwargs.get(name)
        if a is None:
            continue
        if not np.array_equal(a, b):
            repl[name] = np.ascontiguousarray(b)
    meta_delta = {k: int(new_meta[k]) for k in META_FIELDS
                  if prev_meta[k] != new_meta[k]}
    return ProblemDelta(epoch=epoch, base_epoch=base_epoch,
                        checksum=checksum, row_updates=row_updates,
                        repl=repl, meta_delta=meta_delta)


def apply_delta(kwargs: dict, meta: dict, delta: ProblemDelta) -> None:
    """Replay a delta onto (kwargs, meta) in place — the reconstruction
    path of a receiver holding the previous state. Bit-identical by
    construction with
    the state compute_delta diffed against; verified via checksum."""
    for name, (idx, vals) in delta.row_updates.items():
        kwargs[name][idx] = vals
    for name, arr in delta.repl.items():
        kwargs[name] = arr
    meta.update(delta.meta_delta)


# ---------------------------------------------------------------------------
# order-preserving stable ranks
# ---------------------------------------------------------------------------


class StableRanker:
    """Order-preserving integer ranks for a growing set of floats.

    Dense ``np.unique`` ranks shift wholesale when an early value
    leaves the set — one finished workload would dirty every later
    row's timestamp rank. Stable ranks preserve order AND identity:
    once a value has a rank it keeps it; new values get gap midpoints
    (appends, the common churn case, get max+GAP). The kernels only
    compare ranks, so any order-embedding is semantically identical to
    the dense encoding. Gap exhaustion or int32-headroom overflow
    renumbers everything (``renumbers`` counts it; the session turns a
    renumber into a full sync).
    """

    def __init__(self, gap: int = 1 << 10,
                 max_rank: int = 1 << 29) -> None:
        self.gap = gap
        self.max_rank = max_rank
        self._values = np.zeros(0, dtype=np.float64)
        self._ranks = np.zeros(0, dtype=np.int64)
        self.renumbers = 0

    def update(self, values: np.ndarray) -> bool:
        """Register values; True if a renumber changed existing ranks."""
        distinct = np.unique(np.asarray(values, dtype=np.float64))
        if distinct.size == 0:
            return False
        if self._values.size == 0:
            self._values = distinct
            self._ranks = (np.arange(distinct.size, dtype=np.int64)
                           + 1) * self.gap
            return self._maybe_renumber(False)
        idx = np.searchsorted(self._values, distinct)
        present = np.zeros(distinct.size, dtype=bool)
        in_range = idx < self._values.size
        present[in_range] = (
            self._values[idx[in_range]] == distinct[in_range])
        new = distinct[~present]
        if new.size == 0:
            return False
        renumber = False
        tail = new[new > self._values[-1]]
        mid = new[new <= self._values[-1]]
        if mid.size:
            vals = self._values.tolist()
            ranks = self._ranks.tolist()
            for v in mid.tolist():
                i = bisect_left(vals, v)
                lo = ranks[i - 1] if i else 0
                hi = ranks[i]
                r = (lo + hi) // 2
                if r <= lo or r >= hi:
                    renumber = True  # gap exhausted at this position
                    r = lo
                vals.insert(i, v)
                ranks.insert(i, r)
            self._values = np.asarray(vals, dtype=np.float64)
            self._ranks = np.asarray(ranks, dtype=np.int64)
        if tail.size:
            base = int(self._ranks[-1]) if self._ranks.size else 0
            self._values = np.concatenate([self._values, tail])
            self._ranks = np.concatenate([
                self._ranks,
                base + (np.arange(tail.size, dtype=np.int64) + 1)
                * self.gap])
        return self._maybe_renumber(renumber)

    def _maybe_renumber(self, force: bool) -> bool:
        over = self._ranks.size and int(self._ranks[-1]) > self.max_rank
        if not (force or over):
            return False
        gap = self.gap
        while self._values.size * gap > self.max_rank and gap > 1:
            gap //= 2
        self._ranks = (np.arange(self._values.size, dtype=np.int64)
                       + 1) * gap
        self.renumbers += 1
        return True

    def rank(self, values: np.ndarray) -> np.ndarray:
        return self._ranks[np.searchsorted(self._values, values)]

    def rank_before(self, thresholds: np.ndarray) -> np.ndarray:
        """Rank of the largest registered value <= each threshold
        (callers guarantee at least one exists — each row's own value
        is registered)."""
        pos = np.searchsorted(self._values, thresholds, side="right") - 1
        return self._ranks[np.maximum(pos, 0)]

    @property
    def size(self) -> int:
        return int(self._values.size)

    @property
    def max(self) -> int:
        return int(self._ranks[-1]) if self._ranks.size else 0


# ---------------------------------------------------------------------------
# host-side session: slots + stable encodings + delta emission
# ---------------------------------------------------------------------------


@dataclass
class SessionFrame:
    """What one drain ships: a delta when possible, else a full sync."""

    epoch: int
    checksum: int
    delta: Optional[ProblemDelta]  # None => full SYNC required
    full_reason: Optional[str] = None  # why a sync (None when delta)
    stats: dict = field(default_factory=dict)


#: pad_workloads-equivalent inert fill per W-axis array; wl_cqid/wl_rank
#: fills are resolved at slot time (C / BIG). wl_uid fills with BIG so
#: a recycled slot can never alias a legitimate uid-0 workload.
_ROW_FILL = {
    "wl_prio": 0, "wl_ts": 0, "wl_uid": BIG, "wl_req": 0,
    "wl_valid": False, "wl_parked0": False, "wl_admitted0": False,
    "wl_evicted0": False, "wl_admit_rank": 0, "ad_usage": 0,
    "wl_lq": 0, "wl_afs_penalty": 0.0, "wl_ts_buf": 0,
    "wl_raw_ts": 0.0, "wl_raw_admit_ts": 0.0,
}


class HostDeltaSession:
    """Per-kind (lean/full) session state on the scheduler host.

    ``advance(padded_problem)`` returns the slot-stable, rank-stable
    re-encoding of the problem plus the SessionFrame to ship. One
    instance per kernel kind — the lean and full exports differ in
    content, so they are separate sessions on the wire too.
    """

    #: W-axis fields copied straight from the export row in the hint
    #: fast path — everything except the session-stable re-derivations
    #: (wl_ts/wl_ts_buf/wl_admit_rank/wl_class come from the rankers)
    _FAST_DIRECT = (
        "wl_cqid", "wl_rank", "wl_prio", "wl_uid", "wl_req", "wl_valid",
        "wl_parked0", "wl_admitted0", "wl_evicted0", "ad_usage",
        "wl_lq", "wl_afs_penalty")

    def __init__(self, cache=None,
                 neutral_fields: tuple[str, ...] = ()) -> None:
        #: optional ExportCache: per-workload/per-CQ dirty sets feed the
        #: frame stats and the no-change fast path
        self.cache = cache
        #: W-axis arrays this kernel kind never reads (the full kernel
        #: has no wl_rank — FIFO order rides the timestamp ranks), held
        #: at their inert fill so rank churn can't dirty the wire
        self.neutral_fields = tuple(neutral_fields)
        self.epoch = 0
        self._last: Optional[tuple[dict, dict]] = None
        self._last_keys: list[str] = []
        self._slots: dict[str, int] = {}
        self._free: list[int] = []
        self._capacity = -1
        self._ts = StableRanker()
        self._admit = StableRanker()
        self._class_cs = 2  # sticky pow2 class-space (>= max token + 2)
        self._event_mark = 0
        self.full_syncs = 0
        self.delta_syncs = 0
        #: slot->shard interleave width (1 = the classic smallest-slot
        #: policy). With a row-sharded mesh, smallest-slot packs every
        #: churn-era arrival into the low shards while departures
        #: hollow out the high ones — shard_imbalance drifts > 1 on
        #: long-lived sessions. Interleaving assigns new slots round-
        #: robin across the mesh's block shards instead.
        self._interleave = 1
        self._pending_interleave: Optional[int] = None
        #: interleave-change RESYNCs actually taken (epoch migrations)
        self.migrations = 0
        self._rr_cursor = 0
        #: columnar-hint fast path state: the previous slotted problem
        #: (its arrays alias ``_last``'s, so in-place row scatters keep
        #: both views coherent), the last consumed assembly seq, and
        #: the chained cheap checksum
        self._last_slotted: Optional[SolverProblem] = None
        self._hint_seq: Optional[int] = None
        #: when True (engine sets it on the LOCAL path only — no remote
        #: sidecar will recompute state_checksum), fast-path frames
        #: carry a chained checksum over the delta payload instead of
        #: an O(W) crc over the full state
        self.cheap_checksum = False
        self._fast_crc = 0
        self.fast_advances = 0

    # -- slot assignment ---------------------------------------------------

    def set_interleave(self, n_shards: int) -> None:
        """Request slot->shard interleaving over ``n_shards`` block
        shards. A width CHANGE is an epoch migration: the next advance
        re-lays every slot out (one full RESYNC, full_reason
        "interleave_migration", counted in ``migrations``) and resident
        device tensors rebuild once. Width 1 restores the classic
        smallest-slot policy byte-for-byte."""
        n = max(1, int(n_shards))
        if n != self._interleave:
            self._pending_interleave = n

    def _shard_of(self, slot: int) -> int:
        # block sharding over the PADDED axis (capacity + null row),
        # mirroring NamedSharding's layout; the null row rides the last
        # shard
        block = (self._capacity + 1) // self._interleave
        return min(slot // max(1, block), self._interleave - 1)

    def _assign_slots(self, keys: list[str]) -> Optional[np.ndarray]:
        """dst[i] = slot for exported row i (or None on capacity reset)."""
        present = {k for k in keys if k}
        for k in [k for k in self._slots if k not in present]:
            self._free.append(self._slots.pop(k))
        self._free.sort(reverse=True)  # pop() yields the smallest slot
        n = self._interleave
        if n > 1:
            by_shard: list[list[int]] = [[] for _ in range(n)]
            for s in self._free:  # descending, so pop() = smallest
                by_shard[self._shard_of(s)].append(s)
        dst = np.full(len(keys), -1, dtype=np.int64)
        for i, k in enumerate(keys):
            if not k:
                continue
            s = self._slots.get(k)
            if s is None:
                if not self._free:
                    return None  # capacity exhausted: reset + full sync
                if n > 1:
                    # round-robin shard choice; fall through occupied
                    # shards so capacity, not balance, is the only
                    # reset trigger
                    s = None
                    for d in range(n):
                        bucket = by_shard[(self._rr_cursor + d) % n]
                        if bucket:
                            s = bucket.pop()
                            break
                    self._rr_cursor = (self._rr_cursor + 1) % n
                    self._free.remove(s)
                else:
                    s = self._free.pop()
                self._slots[k] = s
            dst[i] = s
        return dst

    def _reset_slots(self, keys: list[str]) -> np.ndarray:
        self._slots = {}
        self._free = []
        dst = np.full(len(keys), -1, dtype=np.int64)
        n = self._interleave
        if n > 1:
            # striped re-layout: row i of the export lands in shard
            # i % n, at that shard's next sequential slot
            block = (len(keys) + 1) // n
            bounds = [min((s + 1) * block, len(keys)) for s in range(n)]
            cursor = [s * block for s in range(n)]
            live = 0
            for i, k in enumerate(keys):
                if not k:
                    continue
                s = None
                for d in range(n):
                    sh = (live + d) % n
                    if cursor[sh] < bounds[sh]:
                        s = cursor[sh]
                        cursor[sh] += 1
                        break
                live += 1
                if s is None:
                    continue  # > capacity: caller's pad guarantees room
                self._slots[k] = s
                dst[i] = s
            taken = set(self._slots.values())
            self._free = sorted(
                (s for s in range(len(keys)) if s not in taken),
                reverse=True)
            return dst
        nxt = 0
        for i, k in enumerate(keys):
            if k:
                self._slots[k] = nxt
                dst[i] = nxt
                nxt += 1
        self._free = list(range(len(keys) - 1, nxt - 1, -1))
        return dst

    # -- the per-drain step ------------------------------------------------

    def advance(self, problem: SolverProblem, hint=None
                ) -> tuple[SolverProblem, SessionFrame]:
        """Re-encode ``problem`` into slot space and emit its frame.

        ``hint`` is the export's ``ColumnarHint`` (solver/columnar.py)
        when the problem came off the columnar scatter/cached path: a
        contiguous-seq hint whose membership did not change lets the
        session scatter just the changed rows into the previous slotted
        encoding — O(dirty) instead of the O(W) permute + content diff.
        Every precondition failure falls back to the classic path,
        which diffs actual array content and is therefore always
        correct regardless of how far the fast path got.
        """
        if hint is not None and not hint.membership_changed:
            fast = self._advance_fast(problem, hint)
            if fast is not None:
                self._hint_seq = hint.seq
                return fast
        out = self._advance_classic(problem)
        self._hint_seq = hint.seq if hint is not None else None
        return out

    def _advance_classic(self, problem: SolverProblem
                         ) -> tuple[SolverProblem, SessionFrame]:
        full_reason = None
        W = problem.n_workloads
        keys = list(problem.wl_keys)
        if W != self._capacity:
            # padded capacity changed => compiled shapes changed anyway
            # (a pending interleave change rides along for free)
            self._capacity = W
            if self._pending_interleave is not None:
                self._interleave = self._pending_interleave
                self._pending_interleave = None
            dst = self._reset_slots(keys)
            full_reason = "shape_change" if self.epoch else "first_sync"
        elif self._pending_interleave is not None:
            # epoch migration: re-lay every slot out under the new
            # interleave width; ONE full RESYNC, resident device
            # tensors rebuild once on the other side
            self._interleave = self._pending_interleave
            self._pending_interleave = None
            self.migrations += 1
            dst = self._reset_slots(keys)
            full_reason = "interleave_migration"
        else:
            dst = self._assign_slots(keys)
            if dst is None:
                dst = self._reset_slots(keys)
                full_reason = "slot_reset"

        # rankers keep every timestamp ever seen so existing ranks never
        # move; once the dead fraction dominates (long-running sessions,
        # finished workloads' timestamps linger), reset them — the
        # wholesale rank change rides the full sync this forces, and the
        # memory/lookup cost stays proportional to the live problem
        active = sum(1 for k in keys if k)
        cap = max(4096, 4 * active)
        if self._ts.size > cap or self._admit.size > cap:
            self._ts = StableRanker()
            self._admit = StableRanker()
            full_reason = full_reason or "ranker_prune"

        slotted = self._permute(problem, dst)
        if self._restamp(slotted):
            full_reason = full_reason or "rank_renumber"

        kwargs, meta = problem_wire_state(slotted)
        checksum = state_checksum(kwargs, meta)
        self.epoch += 1
        stats = self._drain_stats(keys)
        delta = None
        if full_reason is None and self._last is not None:
            delta = compute_delta(self._last[0], self._last[1],
                                  kwargs, meta, epoch=self.epoch,
                                  base_epoch=self.epoch - 1,
                                  checksum=checksum)
            if delta is None:
                full_reason = "dense_delta"
            else:
                delta.stats = stats
        elif full_reason is None:
            full_reason = "first_sync"
        self._last = (kwargs, meta)
        self._last_keys = keys
        self._last_slotted = slotted
        if delta is None:
            self.full_syncs += 1
        else:
            self.delta_syncs += 1
        return slotted, SessionFrame(epoch=self.epoch, checksum=checksum,
                                     delta=delta,
                                     full_reason=full_reason, stats=stats)

    # -- columnar-hint O(dirty) advance ------------------------------------

    def _advance_fast(self, problem: SolverProblem, hint
                      ) -> Optional[tuple[SolverProblem, SessionFrame]]:
        """Scatter the hint's changed rows straight into the previous
        slotted encoding. Returns None when any precondition fails; the
        ranker registrations it may have done before bailing are
        harmless (the classic path re-registers idempotently and diffs
        actual content, so a renumber mid-bail just rides the diff)."""
        prev = self._last_slotted
        if (prev is None or self._last is None or not self.epoch
                or self._hint_seq is None
                or hint.base_seq != self._hint_seq
                or problem.n_workloads != self._capacity
                or self._pending_interleave is not None):
            return None
        active = len(self._slots)
        cap = max(4096, 4 * active)
        if self._ts.size > cap or self._admit.size > cap:
            return None  # classic path prunes the rankers (full sync)
        kwargs, meta = self._last
        if (int(problem.scale) != meta["scale"]
                or int(problem.n_resources) != meta["n_resources"]):
            return None
        ckeys = list(hint.changed)
        slots = np.empty(len(ckeys), dtype=np.int64)
        rows = np.empty(len(ckeys), dtype=np.int64)
        for i, k in enumerate(ckeys):
            s = self._slots.get(k)
            if s is None:
                return None
            slots[i] = s
            rows[i] = hint.changed[k]
        if rows.size and int(rows.max()) >= problem.n_workloads:
            return None

        # new raw timestamps register into the rankers before anything
        # mutates: a renumber moves OTHER rows' ranks, and under the
        # preemption-buffer gate even a plain registry growth can move
        # other rows' buffered ranks — both degrade to classic
        new_raw = np.ascontiguousarray(problem.wl_raw_ts[rows])
        gate = features.enabled("SchedulerTimestampPreemptionBuffer")
        ts_size0 = self._ts.size
        if self._ts.update(new_raw):
            return None
        if gate and active and self._ts.size != ts_size0:
            return None
        new_adm = np.ascontiguousarray(problem.wl_admitted0[rows])
        new_raw_admit = np.ascontiguousarray(
            problem.wl_raw_admit_ts[rows])
        if new_adm.any() and self._admit.update(new_raw_admit[new_adm]):
            return None
        new_tok = np.ascontiguousarray(problem.wl_class_tok[rows])
        root = problem.class_tok_root
        max_tok = int(new_tok.max()) if new_tok.size else -1
        if root is not None:
            max_tok = max(max_tok, len(root) - 1)
        if pow2(max_tok + 2) > self._class_cs:
            return None  # class space must grow: shapes change
        for name in NON_W_FIELDS:
            if name == "class_root":
                continue  # session-derived, handled below
            a, b = kwargs.get(name), getattr(problem, name)
            if (a is None) != (b is None):
                return None
            if a is not None and (a.shape != np.shape(b)
                                  or a.dtype != np.asarray(b).dtype):
                return None

        # -- all preconditions hold; mutate the resident encoding. The
        # kwargs arrays alias the slotted problem's, so one scatter
        # updates the wire state and the returned problem together.
        row_updates: dict[str, tuple[np.ndarray, np.ndarray]] = {}

        def scatter(name: str, new_vals: np.ndarray) -> None:
            arr = kwargs.get(name)
            if arr is None or not slots.size:
                return
            old_vals = arr[slots]
            neq = old_vals != new_vals
            if neq.ndim > 1:
                neq = neq.reshape(len(ckeys), -1).any(axis=1)
            if not neq.any():
                return
            sub = np.nonzero(neq)[0]
            arr[slots[sub]] = new_vals[sub]
            row_updates[name] = (slots[sub].astype(np.int32),
                                 np.ascontiguousarray(new_vals[sub]))

        for name in self._FAST_DIRECT:
            if name in self.neutral_fields:
                continue
            src = getattr(problem, name)
            if src is None:
                continue
            scatter(name, np.ascontiguousarray(src[rows]))

        if slots.size:
            new_ts = self._ts.rank(new_raw).astype(np.int32)
            scatter("wl_ts", new_ts)
            if gate:
                scatter("wl_ts_buf", self._ts.rank_before(
                    new_raw
                    + TIMESTAMP_PREEMPTION_BUFFER_S).astype(np.int32))
            else:
                scatter("wl_ts_buf", new_ts)
            ar = np.zeros(len(ckeys), dtype=np.int32)
            if new_adm.any():
                ar[new_adm] = (self._admit.rank(new_raw_admit[new_adm])
                               + 1).astype(np.int32)
            scatter("wl_admit_rank", ar)
            scatter("wl_class", np.where(
                new_tok >= 0, new_tok,
                self._class_cs - 1).astype(np.int32))
            prev.wl_raw_ts[slots] = new_raw
            prev.wl_raw_admit_ts[slots] = new_raw_admit
            prev.wl_class_tok[slots] = new_tok

        repl: dict[str, np.ndarray] = {}
        cs = self._class_cs
        class_root = np.full(cs, problem.n_nodes, dtype=np.int32)
        if root is not None and len(root):
            class_root[:len(root)] = root
        if not np.array_equal(kwargs["class_root"], class_root):
            repl["class_root"] = class_root
            kwargs["class_root"] = class_root
            prev.class_root = class_root
        for name in NON_W_FIELDS:
            if name == "class_root":
                continue
            a, b = kwargs.get(name), getattr(problem, name)
            if a is None or np.array_equal(a, b):
                continue
            repl[name] = np.ascontiguousarray(b)
            kwargs[name] = repl[name]
            setattr(prev, name, repl[name])
        if root is not None:
            prev.class_tok_root = root

        meta_delta: dict[str, int] = {}
        new_meta = {"n_resources": int(problem.n_resources),
                    "scale": int(problem.scale),
                    "ts_evict_base": self._ts.max + 1,
                    "admit_rank_base": self._admit.max + 2}
        for k in META_FIELDS:
            if meta[k] != new_meta[k]:
                meta_delta[k] = new_meta[k]
                meta[k] = new_meta[k]
        prev.ts_evict_base = new_meta["ts_evict_base"]
        prev.admit_rank_base = new_meta["admit_rank_base"]
        # host-only scalars ride the export (n_classes and friends can
        # move without any wire array changing); the session-derived
        # rank bases above are the only scalars the session owns
        for f in dataclasses.fields(problem):
            if f.name in ("ts_evict_base", "admit_rank_base"):
                continue
            val = getattr(problem, f.name)
            if isinstance(val, (bool, int, float, np.integer,
                                np.floating)):
                setattr(prev, f.name, val)

        self.epoch += 1
        if self.cheap_checksum:
            checksum = self._delta_checksum(row_updates, repl,
                                            meta_delta)
        else:
            checksum = state_checksum(kwargs, meta)
        stats = self._drain_stats_fast(len(ckeys))
        delta = ProblemDelta(epoch=self.epoch, base_epoch=self.epoch - 1,
                             checksum=checksum, row_updates=row_updates,
                             repl=repl, meta_delta=meta_delta,
                             stats=stats)
        self.delta_syncs += 1
        self.fast_advances += 1
        return prev, SessionFrame(epoch=self.epoch, checksum=checksum,
                                  delta=delta, full_reason=None,
                                  stats=stats)

    def _delta_checksum(self, row_updates: dict, repl: dict,
                        meta_delta: dict) -> int:
        """Chained cheap checksum over the delta payload (local-path
        only): NOT comparable with ``state_checksum`` — the engine
        enables it only when no remote sidecar will verify frames, so a
        1M-row session does not pay an O(W) crc per drain."""
        crc = zlib.crc32(f"{self.epoch}|{self._fast_crc}".encode())
        for name in sorted(row_updates):
            idx, vals = row_updates[name]
            crc = zlib.crc32(name.encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(idx).tobytes(), crc)
            crc = zlib.crc32(np.ascontiguousarray(vals).tobytes(), crc)
        for name in sorted(repl):
            crc = zlib.crc32(name.encode(), crc)
            crc = zlib.crc32(
                np.ascontiguousarray(repl[name]).tobytes(), crc)
        crc = zlib.crc32(json.dumps(
            {k: int(v) for k, v in sorted(meta_delta.items())}).encode(),
            crc)
        self._fast_crc = crc & 0xFFFFFFFF
        return self._fast_crc

    def _drain_stats_fast(self, n_changed: int) -> dict:
        stats = {"removed_keys": 0, "added_keys": 0,
                 "fast_rows": n_changed}
        if self.cache is not None:
            stats["dirty_workloads"] = len(self.cache.dirty_keys)
            stats["dirty_cqs"] = len(self.cache.dirty_cqs)
            stats["events"] = self.cache.events_seen - self._event_mark
            self._event_mark = self.cache.events_seen
            self.cache.consume_dirty()
        return stats

    def _drain_stats(self, keys: list[str]) -> dict:
        prev = {k for k in self._last_keys if k}
        cur = {k for k in keys if k}
        stats = {"removed_keys": len(prev - cur),
                 "added_keys": len(cur - prev)}
        if self.cache is not None:
            stats["dirty_workloads"] = len(self.cache.dirty_keys)
            stats["dirty_cqs"] = len(self.cache.dirty_cqs)
            stats["events"] = self.cache.events_seen - self._event_mark
            self._event_mark = self.cache.events_seen
            self.cache.consume_dirty()
        return stats

    def _permute(self, problem: SolverProblem,
                 dst: np.ndarray) -> SolverProblem:
        """Rewrite the workload axis into slot space: out[slot] = row,
        free slots filled with the pad_workloads inert row."""
        W = problem.n_workloads
        C = problem.n_cqs
        occupied = dst >= 0
        src = np.nonzero(occupied)[0]
        slots = dst[occupied]
        updates: dict = {}
        for name in W_AXIS_FIELDS + ("wl_raw_ts", "wl_raw_admit_ts",
                                     "wl_class_tok"):
            arr = getattr(problem, name)
            if arr is None:
                continue
            if name == "wl_cqid":
                fill = C
            elif name == "wl_rank":
                fill = BIG
            elif name == "wl_class":
                fill = problem.n_classes
            elif name == "wl_class_tok":
                fill = -1
            else:
                fill = _ROW_FILL[name]
            out = np.full_like(arr, fill)
            if name not in self.neutral_fields:
                out[-1] = arr[-1]  # the null row stays last
                out[slots] = arr[src]
            updates[name] = out
        out_keys = [""] * W
        for i, s in zip(src, slots):
            out_keys[s] = problem.wl_keys[i]
        updates["wl_keys"] = out_keys
        return dataclasses.replace(problem, **updates)

    def _restamp(self, p: SolverProblem) -> bool:
        """Replace the dense per-export encodings (timestamp ranks,
        admit ranks, scheduling-class ids) with session-stable ones, in
        place on the slotted problem. Returns True when a ranker
        renumber invalidated previous ranks (forces a full sync).

        The kernels only *compare* these values (entry ordering, the
        newer-equal preemption test, candidate recency), so any
        order-preserving embedding is behaviorally identical to the
        dense ``np.unique`` ranks export_problem produces.
        """
        W = p.n_workloads
        occ = p.wl_cqid[:W] < p.n_cqs
        renumbered = False
        raw_ts = p.wl_raw_ts[:W][occ]
        renumbered |= self._ts.update(raw_ts)
        p.wl_ts[:W][occ] = self._ts.rank(raw_ts).astype(np.int32)
        p.wl_ts[:W][~occ] = 0
        if features.enabled("SchedulerTimestampPreemptionBuffer"):
            p.wl_ts_buf[:W][occ] = self._ts.rank_before(
                raw_ts + TIMESTAMP_PREEMPTION_BUFFER_S).astype(np.int32)
        else:
            p.wl_ts_buf[:W][occ] = p.wl_ts[:W][occ]
        p.wl_ts_buf[:W][~occ] = 0
        p.ts_evict_base = self._ts.max + 1

        adm = occ & p.wl_admitted0[:W]
        if adm.any():
            raw_admit = p.wl_raw_admit_ts[:W][adm]
            renumbered |= self._admit.update(raw_admit)
            p.wl_admit_rank[:W] = 0
            p.wl_admit_rank[:W][adm] = (
                self._admit.rank(raw_admit) + 1).astype(np.int32)
        else:
            p.wl_admit_rank[:W] = 0
        p.admit_rank_base = self._admit.max + 2

        # stable scheduling-equivalence classes: raw interned tokens in
        # a sticky pow2 class space (sentinel = CS-1, shared by strict
        # and gate-off rows exactly like the dense sentinel n_classes)
        toks = p.wl_class_tok[:W]
        max_tok = int(toks.max()) if toks.size else -1
        if p.class_tok_root is not None:
            max_tok = max(max_tok, len(p.class_tok_root) - 1)
        self._class_cs = max(self._class_cs, pow2(max_tok + 2))
        cs = self._class_cs
        wl_class = np.full(W + 1, cs - 1, dtype=np.int32)
        pos = toks >= 0
        wl_class[:W][pos] = toks[pos]
        p.wl_class = wl_class
        class_root = np.full(cs, p.n_nodes, dtype=np.int32)
        if p.class_tok_root is not None and len(p.class_tok_root):
            class_root[:len(p.class_tok_root)] = p.class_tok_root
        p.class_root = class_root
        return bool(renumbered)


# ---------------------------------------------------------------------------
# resident device tensors
# ---------------------------------------------------------------------------

#: problem W-axis field -> ProblemTensors field (lean kernel)
_LEAN_ROW_TENSORS = {n: n for n in (
    "wl_cqid", "wl_rank", "wl_prio", "wl_ts", "wl_uid", "wl_req",
    "wl_valid")}
#: problem W-axis field -> FullTensors field
_FULL_ROW_TENSORS = {
    "wl_cqid": "wl_cqid", "wl_prio": "wl_prio", "wl_ts": "wl_ts0",
    "wl_uid": "wl_uid", "wl_req": "wl_req", "wl_valid": "wl_valid",
    "wl_parked0": "wl_parked0", "wl_admitted0": "wl_admitted0",
    "wl_evicted0": "wl_evicted0", "wl_admit_rank": "wl_admit_rank0",
    "ad_usage": "ad_usage", "wl_class": "wl_class", "wl_lq": "wl_lq",
    "wl_afs_penalty": "wl_afs_penalty", "wl_ts_buf": "wl_ts_buf",
}
#: derived tensors and the problem fields they are computed from
_DERIVED = {"is_cq": ("cq_node", "parent"),
            "cq_opt_pos": ("cq_opt_group",),
            "res_onehot": ("fr_resource",)}


def _tree_nbytes(t) -> int:
    return sum(int(a.numel() * a.element_size()) for a in t)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over ``a``'s bytes (contiguous and writable, copied
    only when ``a`` is neither)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


class DeviceResidentProblem:
    """Padded problem tensors kept on ``device`` across drains.

    A full sync uploads everything once; each delta epoch then writes
    only the dirty rows into the resident buffers (``index_copy_``) and
    refreshes the small node / ClusterQueue replacements and the 0-d
    rank bases, so steady-state drains ship a few KB to the device
    instead of the whole padded problem. A later full sync whose shapes
    and dtypes all match rewrites the resident buffers in place
    (``copy_``) instead of allocating a second set.

    The JAX class donates buffers to jitted ``.at[rows].set`` scatters
    and pads the dirty-row count to a power of two to bound its
    recompiles; PyTorch updates in place and compiles nothing, so the
    port neither donates nor pads. Mesh placement (``mesh=``) is cut:
    the port runs on one device.

    Every upload copies: a resident tensor never shares memory with a
    host array (on the CPU ``torch.as_tensor`` would alias the session's
    slotted arrays, which the session mutates in place). Row updates
    need an int64 index and values of the buffer's exact dtype; a
    mismatch raises (and heals through a full upload, counted in
    ``apply_faults``) instead of casting.
    """

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.kind: Optional[str] = None
        self.epoch = -1
        self.tensors = None
        self.full_uploads = 0
        self.delta_updates = 0
        #: bytes written into resident buffers in place (row updates
        #: and in-place full syncs)
        self.donated_update_bytes = 0
        self.full_upload_bytes = 0
        #: full syncs that rewrote the previous epoch's buffers in place
        self.donated_full_syncs = 0
        #: delta applications that failed and healed by a full upload
        self.apply_faults = 0

    def resident_bytes(self) -> int:
        """Bytes of problem state currently held on the device."""
        return _tree_nbytes(self.tensors) if self.tensors is not None \
            else 0

    def update(self, problem: SolverProblem, frame: Optional[SessionFrame],
               full: bool):
        kind = "full" if full else "lean"
        delta = frame.delta if frame is not None else None
        if (delta is None or self.tensors is None or self.kind != kind
                or delta.base_epoch != self.epoch):
            self.tensors = self._full_upload(problem, full)
        else:
            try:
                self._apply(problem, delta, full)
            except Exception:
                # a partly applied delta leaves the buffers half
                # updated: drop them (so the heal cannot write into
                # them) and re-seed from the host problem
                self.apply_faults += 1
                self.tensors = None
                self.tensors = self._full_upload(problem, full)
        self.kind = kind
        self.epoch = frame.epoch if frame is not None else self.epoch + 1
        return self.tensors

    @staticmethod
    def _host(problem: SolverProblem, full: bool):
        if full:
            from kueue_oss_tpu_torch.solver.full_kernels import (
                host_tensors_full,
            )

            return host_tensors_full(problem)
        from kueue_oss_tpu_torch.solver.kernels import host_tensors

        return host_tensors(problem)

    def _full_upload(self, problem: SolverProblem, full: bool):
        host = self._host(problem, full)
        kind = "full" if full else "lean"
        prev = self.tensors if self.kind == kind else None
        if prev is not None and self._donation_compatible(prev, host):
            du = self.donated_update_bytes
            try:
                for old, new in zip(prev, host):
                    old.copy_(_host_tensor(new))
                    self.donated_update_bytes += int(np.asarray(new).nbytes)
            except RuntimeError:
                self.donated_update_bytes = du
                self.apply_faults += 1
            else:
                self.donated_full_syncs += 1
                self.full_uploads += 1
                self.full_upload_bytes += _tree_nbytes(prev)
                return prev
        t = type(host)(*(torch.tensor(np.asarray(a), device=self.device)
                         for a in host))
        self.full_uploads += 1
        self.full_upload_bytes += _tree_nbytes(t)
        return t

    @staticmethod
    def _donation_compatible(prev, host) -> bool:
        """Every resident buffer matches its replacement's shape and
        dtype exactly."""
        for old, new in zip(prev, host):
            new = np.asarray(new)
            if (tuple(old.shape) != new.shape
                    or old.dtype != _torch_dtype(new.dtype)):
                return False
        return True

    def _write_rows(self, buf: torch.Tensor, idx: np.ndarray,
                    vals: np.ndarray) -> None:
        """``buf[idx] = vals`` in place: int64 index, unique rows (a
        repeated index makes ``index_copy_`` nondeterministic on CUDA),
        values of the buffer's exact dtype."""
        idx = np.asarray(idx)
        vals = np.asarray(vals)
        src = _host_tensor(vals)
        if src.dtype != buf.dtype:
            raise TypeError(f"row update of dtype {src.dtype} for a "
                            f"{buf.dtype} buffer")
        if (idx.ndim != 1 or vals.shape != (idx.size,) + tuple(buf.shape[1:])
                or np.unique(idx).size != idx.size):
            raise ValueError(f"row update {idx.shape} / {vals.shape} does "
                             f"not address unique rows of {tuple(buf.shape)}")
        index = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        buf.index_copy_(0, index, src.to(self.device))
        self.donated_update_bytes += int(index.numel() * 8) + int(vals.nbytes)

    @staticmethod
    def _write_all(buf: torch.Tensor, arr: np.ndarray) -> None:
        src = _host_tensor(np.asarray(arr))
        if src.dtype != buf.dtype or tuple(src.shape) != tuple(buf.shape):
            raise TypeError(f"replacement {src.dtype}{tuple(src.shape)} for "
                            f"a {buf.dtype}{tuple(buf.shape)} buffer")
        buf.copy_(src)

    def _apply(self, problem: SolverProblem, delta: ProblemDelta,
               full: bool) -> None:
        t = self.tensors
        fields = set(t._fields)
        row_map = _FULL_ROW_TENSORS if full else _LEAN_ROW_TENSORS
        for name, (idx, vals) in delta.row_updates.items():
            tname = row_map.get(name)
            if tname is not None:
                self._write_rows(getattr(t, tname), idx, vals)
        for name, arr in delta.repl.items():
            if name in fields:
                self._write_all(getattr(t, name), arr)
        derived = [d for d, srcs in _DERIVED.items()
                   if d in fields and any(s in delta.repl for s in srcs)]
        if derived:
            host = self._host(problem, full)
            for d in derived:
                self._write_all(getattr(t, d), getattr(host, d))
        if full:
            # the 0-d rank bases take a host int: no device read-back
            for name in ("ts_evict_base", "admit_rank_base"):
                if name in delta.meta_delta:
                    getattr(t, name).fill_(int(getattr(problem, name)))
        self.delta_updates += 1
