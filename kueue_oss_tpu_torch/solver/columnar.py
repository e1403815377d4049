"""Columnar, delta-native store -> tensor assembly.

Port of ``kueue_oss_tpu/solver/columnar.py``. :func:`tensors.
export_problem`'s per-workload walk is O(W) Python per drain even when
little changed. :class:`ColumnarStore` keeps the export decomposed into
flat numpy *blocks* (one per (section, ClusterQueue): heap / parked /
admitted) that are updated in place from the ``ExportCache`` dirty-key
feed, so a re-export is one of four escalating paths:

``cached``
    Nothing changed (memberships identical, no store events): return
    the previously assembled :class:`SolverProblem` object.
``scatter``
    Row content changed but no workload entered or left any section:
    rebuild only the dirty rows, copy-on-write the affected columns,
    and re-derive only the groups whose inputs moved (timestamp ranks,
    class densify, request gathers).
``assemble``
    Membership changed: rebuild only the blocks whose lists changed,
    then re-concatenate with vectorized post-processing.
``rebuild``
    The export stamp moved (spec edit, vocabulary change): everything
    is re-derived, as the classic walk would.

Bit-identity contract: for the SAME :class:`ExportCache` every array of
the returned problem is byte-identical to the classic walk's
(``export_problem(..., columnar=False)``). What this view cannot prove
identical (AFS-active exports, caller-pinned snapshots) returns ``None``
so the classic walk runs; a bail-out is counted in ``bailouts`` (the
JAX package's metric is cut from the copy).

The returned problem is READ-ONLY: the ``cached`` path returns the same
object again, and the ``scatter`` path aliases every unchanged array
into the new problem.

Each export attaches a :class:`ColumnarHint` as
``problem._columnar_hint``: the changed-row positions that let
``HostDeltaSession`` (solver/delta.py) encode a delta from the dirty
columns instead of re-diffing two full padded exports.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.solver import tensors as T

__all__ = ["ColumnarStore", "ColumnarHint"]

#: dirty-log compaction bound: past this many un-drained events the
#: incremental bookkeeping is worth less than a fresh build.
_LOG_CAP = 1 << 20


def _infos_match(a, b) -> bool:
    """Membership check with a per-element identity shortcut.

    ``pending_backlog`` rebuilds its lists every call but reuses the
    WorkloadInfo objects for untouched entries, so a plain ``a == b``
    runs the full dataclass field compare for every member — dataclass
    ``__eq__`` has no identity fast path, which turns the validity scan
    O(W x fields).
    ``x is y`` settles the common case; the value compare only runs for
    rebuilt-but-equal infos."""
    if a is b:
        return True
    if a is None or b is None or len(a) != len(b):
        return False
    return all(x is y or x == y for x, y in zip(a, b))


class ColumnarHint:
    """Delta-session side-channel riding each columnar export.

    ``seq``/``base_seq`` chain consecutive exports of the same mode
    (lean vs full); ``changed`` maps workload key → row position in the
    *unpadded* problem (positions survive :func:`tensors.pad_workloads`
    because inert rows are inserted before the null row). When
    ``membership_changed`` is set the positions are meaningless and the
    session must run its classic content diff.
    """

    __slots__ = ("seq", "base_seq", "membership_changed", "changed",
                 "mode", "n_workloads")

    def __init__(self, seq: int, base_seq: int, membership_changed: bool,
                 changed: dict, mode: str, n_workloads: int):
        self.seq = seq
        self.base_seq = base_seq
        self.membership_changed = membership_changed
        self.changed = changed
        self.mode = mode
        self.n_workloads = n_workloads


class _Block:
    """One section's rows for one ClusterQueue as flat numpy columns.

    ``kind`` is "h" (heap, FIFO rank = position), "p" (parked, rank
    BIG) or "a" (the single admitted block, rank BIG + admission
    usage). Content columns mirror the per-row quantities the classic
    walk pulls out of ``ExportCache`` rows; membership validity is an
    identity compare of ``infos`` against the caller's current list.
    """

    __slots__ = ("kind", "infos", "keys", "cids", "prio", "uid",
                 "raw_ts", "evicted", "shape_id", "class_tok",
                 "admit_ts", "rows", "cq_frs", "u_rows", "u_fs", "u_qs",
                 "member_seq", "log_pos", "events_mark", "_pos")

    def __init__(self, kind: str):
        self.kind = kind
        self._pos: Optional[dict] = None

    def pos(self) -> dict:
        if self._pos is None:
            self._pos = {k: i for i, k in enumerate(self.keys)}
        return self._pos


class _Assembly:
    """One mode's (lean or full) cached final problem + re-derivation
    inputs, with the marks that prove it still current."""

    __slots__ = ("order", "build_seqs", "log_pos", "log_epoch", "stamp",
                 "snap_mark", "stack_len", "tok_len", "scale", "problem",
                 "seq", "offsets", "n_heap", "n_pending", "W", "toks",
                 "shape_ids", "ad_usage_raw", "n_ts", "n_admit_rank",
                 "n_classes")


class _Restart(Exception):
    """A patched row drifted to another CQ mid-validation; re-derive
    the vocabulary with that block invalidated."""


class ColumnarStore:
    """Incremental columnar view over one subscribed ExportCache."""

    def __init__(self, cache) -> None:
        self.cache = cache
        self._blocks: dict[tuple, _Block] = {}
        self._key_home: dict[str, tuple] = {}
        #: append-only dirty-key log; blocks and assemblies carry
        #: positions into it (compacted by invalidating both).
        self._log: list[str] = []
        self._log_epoch = 0
        self._asms: dict[bool, _Assembly] = {}
        self._row_stamp: Optional[tuple] = None
        self._snap_mark: Optional[tuple] = None
        self._snapshot = None
        self._nodes: Optional[list] = None
        self._node_frs: Optional[set] = None
        self._usage_key = None
        self._usage_raw: Optional[np.ndarray] = None
        self._spec_key = None
        self._spec: Optional[dict] = None
        self._cq_frs_gen = -1
        self._cq_frs_map: dict[str, set] = {}
        self._build_seq = 0
        self.exports = 0
        #: exports handed back to the classic walk, by reason (the JAX
        #: package counts them in a metric; the port has no metrics)
        self.bailouts: dict[str, int] = {}
        #: timing/mode statistics of the most recent export (the engine
        #: folds them into its export_walk / export_scatter phases)
        self.last_stats: dict = {}

    # -- event feed --------------------------------------------------------

    def note_dirty(self, key: str) -> None:
        """Called by ExportCache._on_event for every Workload event."""
        self._log.append(key)
        if len(self._log) >= _LOG_CAP:
            # Compact: positions into the log die, so anything that
            # relied on them (block row currency, assembly patch sets)
            # must rebuild from scratch on the next export.
            self._log = []
            self._log_epoch += 1
            self._blocks.clear()
            self._key_home.clear()
            self._asms.clear()

    # -- spec-keyed derived state -----------------------------------------

    def _cq_frs(self, name: str, spec_gen: int) -> set:
        """(flavor, resource) vocabulary contribution of one CQ's
        resource groups — the classic per-pending-info expansion, keyed
        per CQ per spec generation."""
        if self._cq_frs_gen != spec_gen:
            self._cq_frs_map = {}
            self._cq_frs_gen = spec_gen
        s = self._cq_frs_map.get(name)
        if s is None:
            cq = self.cache.store.cluster_queues[name]
            s = {(fq.name, r) for rg in cq.resource_groups
                 for fq in rg.flavors for r in rg.covered_resources}
            self._cq_frs_map[name] = s
        return s

    def _spec_state(self, spec_gen: int, fr_list: list, forest,
                    nodes: list) -> dict:
        """Node-structural and CQ arrays (everything in the classic
        export that depends only on specs + the FR vocabulary, not on
        usage or the backlog), cached per (spec_gen, fr vocabulary)."""
        key = (spec_gen, tuple(fr_list))
        if self._spec_key == key:
            return self._spec

        store = self.cache.store
        fr_index = {fr: i for i, fr in enumerate(fr_list)}
        F = max(1, len(fr_list))
        n_nodes = len(nodes)
        null = n_nodes
        index = {id(n): i for i, n in enumerate(nodes)}

        parent = np.full(n_nodes + 1, null, dtype=np.int32)
        depth = np.zeros(n_nodes + 1, dtype=np.int32)
        has_parent = np.zeros(n_nodes + 1, dtype=bool)
        nominal = np.zeros((n_nodes + 1, F), dtype=np.int64)
        subtree = np.zeros((n_nodes + 1, F), dtype=np.int64)
        local_quota = np.zeros((n_nodes + 1, F), dtype=np.int64)
        has_borrow = np.zeros((n_nodes + 1, F), dtype=bool)
        borrow_limit = np.zeros((n_nodes + 1, F), dtype=np.int64)
        for i, n in enumerate(nodes):
            if n.parent is not None:
                parent[i] = index[id(n.parent)]
                has_parent[i] = True
                depth[i] = depth[parent[i]] + 1
            for fr, q in n.quotas.items():
                j = fr_index[fr]
                nominal[i, j] = q.nominal
                if q.borrowing_limit is not None:
                    has_borrow[i, j] = True
                    borrow_limit[i, j] = q.borrowing_limit
            for fr, v in n.subtree_quota.items():
                subtree[i, fr_index[fr]] = v
            for j, fr in enumerate(fr_list):
                local_quota[i, j] = n.local_quota(fr)

        D = int(depth.max()) + 1 if n_nodes else 1
        path = np.full((n_nodes + 1, D), null, dtype=np.int32)
        for i, n in enumerate(nodes):
            cur, d = i, 0
            while cur != null and d < D:
                path[i, d] = cur
                cur = parent[cur]
                d += 1

        height = np.zeros(n_nodes + 1, dtype=np.int32)
        for i in range(n_nodes - 1, -1, -1):
            n = nodes[i]
            h = min(len(n.children), 1)
            for c in n.children.values():
                if not c.is_cq:
                    h = max(h, height[index[id(c)]] + 1)
            height[i] = h

        cq_names = sorted(forest.cqs.keys())
        C = len(cq_names)
        cq_node = np.zeros(C, dtype=np.int32)
        cq_strict = np.zeros(C, dtype=bool)
        cq_try_next = np.zeros(C, dtype=bool)
        cq_root_height = np.zeros(C, dtype=np.int32)
        cq_nflavors = np.zeros(C, dtype=np.int32)
        cq_within_policy = np.zeros(C, dtype=np.int32)
        cq_reclaim_policy = np.zeros(C, dtype=np.int32)
        cq_bwc_forbidden = np.zeros(C, dtype=bool)
        cq_bwc_threshold = np.full(C, T.NO_THRESHOLD, dtype=np.int32)
        cq_preempt_try_next = np.zeros(C, dtype=bool)
        cq_pref_pob = np.zeros(C, dtype=bool)
        cq_fair_weight = np.ones(C, dtype=np.float32)
        cq_root = np.zeros(C, dtype=np.int32)
        cq_ngroups = np.ones(C, dtype=np.int32)
        cq_afs_spec = np.zeros(C, dtype=bool)
        cq_option_flavors: dict[str, list[str]] = {}
        cq_resource_group: dict[str, dict[str, int]] = {}
        cq_options: dict[str, list[tuple[int, str]]] = {}
        K = 1
        for cid, name in enumerate(cq_names):
            spec = store.cluster_queues[name]
            node = forest.cqs[name]
            cq_node[cid] = index[id(node)]
            cq_strict[cid] = (spec.queueing_strategy
                              == T.QueueingStrategy.STRICT_FIFO)
            cq_try_next[cid] = (
                spec.flavor_fungibility.when_can_borrow
                == T.FlavorFungibilityPolicy.TRY_NEXT_FLAVOR)
            cq_preempt_try_next[cid] = (
                spec.flavor_fungibility.when_can_preempt
                == T.FlavorFungibilityPolicy.TRY_NEXT_FLAVOR)
            cq_pref_pob[cid] = (
                spec.flavor_fungibility.preference
                == T.FlavorFungibilityPreference.PREEMPTION_OVER_BORROWING)
            cq_root_height[cid] = height[index[id(node.root())]]
            cq_root[cid] = index[id(node.root())]
            cq_within_policy[cid] = T._POLICY_CODE[
                spec.preemption.within_cluster_queue]
            cq_reclaim_policy[cid] = T._POLICY_CODE[
                spec.preemption.reclaim_within_cohort]
            bwc = spec.preemption.borrow_within_cohort
            cq_bwc_forbidden[cid] = (
                bwc.policy == T.PreemptionPolicyValue.NEVER)
            if bwc.max_priority_threshold is not None:
                cq_bwc_threshold[cid] = bwc.max_priority_threshold
            cq_fair_weight[cid] = spec.fair_sharing.weight
            scope = spec.admission_scope
            cq_afs_spec[cid] = (
                scope is not None
                and scope.admission_mode == "UsageBasedAdmissionFairSharing")
            options: list[tuple[int, str]] = []
            rg_of_resource: dict[str, int] = {}
            for g, rg in enumerate(spec.resource_groups):
                for r in rg.covered_resources:
                    rg_of_resource[r] = g
                for fq in rg.flavors:
                    options.append((g, fq.name))
            cq_options[name] = options
            cq_option_flavors[name] = [f for _, f in options]
            cq_resource_group[name] = rg_of_resource
            cq_ngroups[cid] = max(1, len(spec.resource_groups))
            cq_nflavors[cid] = len(options)
            K = max(K, len(options))

        cq_opt_group = np.full((C, K), -1, dtype=np.int32)
        for cid, name in enumerate(cq_names):
            for k, (g, _) in enumerate(cq_options[name]):
                cq_opt_group[cid, k] = g

        resources = sorted({fr[1] for fr in fr_list}) or ["_"]
        res_index = {r: i for i, r in enumerate(resources)}
        fr_resource = np.asarray(
            [res_index[fr[1]] for fr in fr_list] or [0], dtype=np.int32)
        node_fair_weight = np.ones(n_nodes + 1, dtype=np.float32)
        for i, n in enumerate(nodes):
            node_fair_weight[i] = n.fair_weight
        node_names = [n.name for n in nodes]

        self._spec = dict(
            fr_list=list(fr_list), fr_index=fr_index, F=F,
            n_nodes=n_nodes, parent=parent, depth=depth,
            has_parent=has_parent, path=path, height=height,
            nominal=nominal, subtree=subtree, local_quota=local_quota,
            has_borrow=has_borrow, borrow_limit=borrow_limit,
            cq_names=cq_names, C=C, cq_node=cq_node, cq_strict=cq_strict,
            cq_try_next=cq_try_next, cq_root_height=cq_root_height,
            cq_nflavors=cq_nflavors, cq_within_policy=cq_within_policy,
            cq_reclaim_policy=cq_reclaim_policy,
            cq_bwc_forbidden=cq_bwc_forbidden,
            cq_bwc_threshold=cq_bwc_threshold,
            cq_preempt_try_next=cq_preempt_try_next,
            cq_pref_pob=cq_pref_pob, cq_fair_weight=cq_fair_weight,
            cq_root=cq_root, cq_ngroups=cq_ngroups,
            cq_opt_group=cq_opt_group, cq_afs_spec=cq_afs_spec,
            cq_afs_zero=np.zeros(C, dtype=bool),
            cq_id={name: i for i, name in enumerate(cq_names)},
            cq_option_flavors=cq_option_flavors,
            cq_resource_group=cq_resource_group, K=K,
            n_resources=len(resources), fr_resource=fr_resource,
            node_fair_weight=node_fair_weight, node_names=node_names)
        self._spec_key = key
        return self._spec

    def _usage0(self, spec: dict, nodes: list) -> np.ndarray:
        """Unscaled node usage matrix, keyed per (snapshot, vocabulary)."""
        key = (self._snap_mark, tuple(spec["fr_list"]))
        if self._usage_key == key:
            return self._usage_raw
        fr_index = spec["fr_index"]
        usage0 = np.zeros((spec["n_nodes"] + 1, spec["F"]), dtype=np.int64)
        for i, n in enumerate(nodes):
            for fr, v in n.usage.items():
                usage0[i, fr_index[fr]] = v
        self._usage_key = key
        self._usage_raw = usage0
        return usage0

    # -- block maintenance -------------------------------------------------

    def _build_block(self, bk: tuple, infos: list, spec: dict,
                     stamp: tuple) -> _Block:
        old = self._blocks.get(bk)
        cache = self.cache
        cq_id = spec["cq_id"]
        cq_strict = spec["cq_strict"]
        cq_root = spec["cq_root"]
        K, F = spec["K"], spec["F"]
        blk = _Block(bk[0])
        n = len(infos)
        blk.infos = infos
        blk.keys = [i.key for i in infos]
        cids = np.zeros(n, dtype=np.int32)
        rows = []
        cq_set = set()
        for idx, info in enumerate(infos):
            cid = cq_id[info.cluster_queue]
            cids[idx] = cid
            cq_set.add(info.cluster_queue)
            rows.append(cache.row(info, cid, stamp, bool(cq_strict[cid]),
                                  int(cq_root[cid]), K, F))
        blk.cids = cids
        blk.rows = rows
        blk.prio = np.fromiter((r.prio for r in rows), np.int64, n)
        blk.uid = np.fromiter((r.uid for r in rows), np.int64, n)
        blk.raw_ts = np.fromiter((r.raw_ts for r in rows), np.float64, n)
        blk.evicted = np.fromiter((r.evicted for r in rows), bool, n)
        blk.shape_id = np.fromiter((r.shape_id for r in rows), np.int64, n)
        blk.class_tok = np.fromiter((r.class_tok for r in rows),
                                    np.int64, n)
        blk.admit_ts = np.fromiter((r.admit_ts for r in rows),
                                   np.float64, n)
        blk.cq_frs = set()
        if bk[0] == "h":
            for name in cq_set:
                blk.cq_frs |= self._cq_frs(name, cache.spec_gen)
        if bk[0] == "a":
            self._admitted_usage(blk)
        blk._pos = None
        # The queue manager re-wraps a workload in a fresh WorkloadInfo
        # on every update, so content-only churn still fails the
        # membership identity compare. When the key sequence (and CQ
        # assignment) is unchanged, this rebuild is content-only: keep
        # the membership seq stable and log the rows that actually
        # moved, so the scatter path and the delta hint see O(dirty)
        # changed rows instead of a membership change.
        if (old is not None and old.kind == blk.kind and blk.kind != "a"
                and old.keys == blk.keys
                and np.array_equal(old.cids, blk.cids)):
            blk.member_seq = old.member_seq
            diff = ((old.prio != blk.prio) | (old.uid != blk.uid)
                    | (old.raw_ts != blk.raw_ts)
                    | (old.evicted != blk.evicted)
                    | (old.shape_id != blk.shape_id)
                    | (old.class_tok != blk.class_tok)
                    | (old.admit_ts != blk.admit_ts))
            for idx in np.nonzero(diff)[0]:
                self._log.append(blk.keys[idx])
        else:
            self._build_seq += 1
            blk.member_seq = self._build_seq
        blk.log_pos = len(self._log)
        blk.events_mark = cache.events_seen
        self._blocks[bk] = blk
        for k in blk.keys:
            self._key_home[k] = bk
        return blk

    @staticmethod
    def _admitted_usage(blk: _Block) -> None:
        """(Re)build the admitted block's COO usage triplets from its
        cached rows — O(admitted) list walk, no cache.row calls."""
        u_rows, u_fs, u_qs = [], [], []
        for li, r in enumerate(blk.rows):
            if r.usage_fs is not None and r.usage_fs.size:
                u_rows.append(np.full(r.usage_fs.size, li,
                                      dtype=np.int64))
                u_fs.append(r.usage_fs)
                u_qs.append(r.usage_qs)
        blk.u_rows = _concat(u_rows, np.int64)
        blk.u_fs = _concat(u_fs, np.int64)
        blk.u_qs = _concat(u_qs, np.int64)

    def _patch_valid_rows(self, order: list, valid: dict,
                          spec: dict, stamp: tuple) -> None:
        """Bring every membership-valid block current with the dirty
        log in ONE pass over the log tail, routed through
        ``_key_home`` — the per-block scan this replaces probed every
        dirty key against every block, O(blocks x dirty) per export at
        fleet scale. Entries below a block's own log_pos re-apply
        idempotently (the row rebuild reads current cache state), so
        the shared tail needs no per-block slicing. Raises _Restart
        when a row's CQ drifted (that is a membership-level change in
        disguise)."""
        log_len = len(self._log)
        targets = {bk: self._blocks[bk] for bk in order
                   if valid.get(bk) and bk in self._blocks}
        start = min((b.log_pos for b in targets.values()),
                    default=log_len)
        if start >= log_len:
            return
        cache = self.cache
        cq_id = spec["cq_id"]
        cq_strict = spec["cq_strict"]
        cq_root = spec["cq_root"]
        K, F = spec["K"], spec["F"]
        touched_admitted = None
        for key in set(self._log[start:]):
            bk = self._key_home.get(key)
            blk = targets.get(bk)
            if blk is None:
                continue  # gone, or its block rebuilds below anyway
            idx = blk.pos().get(key)
            if idx is None:
                continue
            info = blk.infos[idx]
            cid = cq_id.get(info.cluster_queue)
            if cid is None or cid != blk.cids[idx]:
                del self._blocks[bk]
                raise _Restart
            r = cache.row(info, cid, stamp, bool(cq_strict[cid]),
                          int(cq_root[cid]), K, F)
            blk.rows[idx] = r
            blk.prio[idx] = r.prio
            blk.uid[idx] = r.uid
            blk.raw_ts[idx] = r.raw_ts
            blk.evicted[idx] = r.evicted
            blk.shape_id[idx] = r.shape_id
            blk.class_tok[idx] = r.class_tok
            blk.admit_ts[idx] = r.admit_ts
            if blk.kind == "a":
                touched_admitted = blk
        if touched_admitted is not None:
            self._admitted_usage(touched_admitted)
        for blk in targets.values():
            blk.log_pos = log_len

    # -- export ------------------------------------------------------------

    def export(self, pending, include_admitted: bool = False,
               parked=None, afs=None, now: float = 0.0):
        """Columnar twin of :func:`tensors.export_problem`; returns
        ``None`` to hand the export back to the classic walk."""
        t0 = time.perf_counter()
        cache = self.cache
        store = cache.store
        events = cache.events_seen
        spec_gen = cache.spec_gen

        # Fresh snapshot only when the store moved: the cohort forest
        # and its usage are a pure function of (events, spec).
        if self._snap_mark != (events, spec_gen):
            self._snapshot = build_snapshot(store)
            self._nodes = T.order_nodes(self._snapshot.forest)
            self._snap_mark = (events, spec_gen)
            self._node_frs = None
        forest = self._snapshot.forest
        nodes = self._nodes
        if self._node_frs is None:
            frs: set = set()
            for n in nodes:
                frs.update(n.quotas.keys())
                frs.update(n.usage.keys())
            self._node_frs = frs

        # Section layout in classic walk order: pending, parked,
        # admitted. Each (section, CQ) is one block.
        order: list[tuple] = [("h", name) for name in pending]
        section_infos: dict[tuple, list] = {
            ("h", name): infos for name, infos in pending.items()}
        if parked:
            for name, infos in parked.items():
                order.append(("p", name))
                section_infos[("p", name)] = infos
        if include_admitted:
            order.append(("a",))

        walk_s = 0.0
        for _attempt in range(3):
            # Membership validation + FR vocabulary. A valid block's
            # vocabulary contribution is membership-derived, so its
            # cached expansion set stands in for the per-info walk.
            valid: dict[tuple, bool] = {}
            cq_union = set(self._node_frs)
            for bk in order:
                if bk[0] == "a":
                    blk = self._blocks.get(bk)
                    ok = blk is not None and blk.events_mark == events
                    if blk is not None and not ok:
                        # Row-granular revalidation: any store event
                        # used to retire the whole admitted section
                        # (O(admitted) row rebuild). Membership is a
                        # key/CQ sequence compare against a fresh info
                        # list; when it holds, swap in the fresh infos
                        # (rows rebuild from info content) and let the
                        # dirty log drive O(dirty) row patches instead.
                        infos = [i for i in store.admitted_infos()
                                 if i.cluster_queue in forest.cqs]
                        section_infos[bk] = infos
                        if (len(infos) == len(blk.infos)
                                and all(a is b or (
                                    a.key == b.key
                                    and a.cluster_queue
                                    == b.cluster_queue)
                                    for a, b in zip(infos, blk.infos))):
                            blk.infos = infos
                            blk.events_mark = events
                            ok = True
                    valid[bk] = ok
                    continue
                infos = section_infos[bk]
                blk = self._blocks.get(bk)
                ok = blk is not None and _infos_match(blk.infos, infos)
                valid[bk] = ok
                if bk[0] == "h":
                    if ok:
                        cq_union |= blk.cq_frs
                    else:
                        seen: set = set()
                        for info in infos:
                            name = info.cluster_queue
                            if name not in seen:
                                seen.add(name)
                                cq_union |= self._cq_frs(name, spec_gen)
            fr_list = sorted(cq_union)
            spec = self._spec_state(spec_gen, fr_list, forest, nodes)
            # AFS-active exports thread per-LQ decayed penalties through
            # a per-row walk; bail to the classic path before the block
            # walk, whose work it would throw away (the blocks stay
            # membership-validated and catch up on the dirty log later)
            if afs is not None and spec["cq_afs_spec"].any():
                return self._bailout("afs_active", t0, walk_s)
            stamp = cache.refresh(fr_list, spec["cq_names"], spec["K"],
                                  spec["F"])
            cache.cq_tables(spec["cq_names"])
            if stamp != self._row_stamp:
                # Every cached row/shape/token was retired by
                # cache.refresh — blocks hold dangling references.
                self._blocks.clear()
                self._key_home.clear()
                self._asms.clear()
                self._row_stamp = stamp
                continue

            tw = time.perf_counter()
            try:
                rebuilt = 0
                self._patch_valid_rows(order, valid, spec, stamp)
                for bk in order:
                    if valid[bk]:
                        continue
                    if bk[0] == "a" and bk not in section_infos:
                        infos = [i for i in store.admitted_infos()
                                 if i.cluster_queue in spec["cq_id"]]
                        section_infos[bk] = infos
                    self._build_block(bk, section_infos[bk], spec,
                                      stamp)
                    rebuilt += 1
            except _Restart:
                walk_s += time.perf_counter() - tw
                continue
            walk_s += time.perf_counter() - tw
            break
        else:
            return self._bailout("retry_exhausted", t0, walk_s)

        asm = self._asms.get(include_admitted)
        membership_ok = (
            asm is not None and asm.stamp == stamp
            and asm.log_epoch == self._log_epoch
            and asm.order == order
            and all(self._blocks[bk].member_seq == asm.build_seqs[bk]
                    for bk in order))
        mode = None if membership_ok else "assemble"

        if mode is None and asm.log_pos == len(self._log) \
                and asm.snap_mark == self._snap_mark:
            problem = self._refresh_cached(asm, spec)
            if problem is not None:
                self.exports += 1
                problem._columnar_hint = ColumnarHint(
                    asm.seq, asm.seq - 1, False, {}, "cached", asm.W)
                self.last_stats = {
                    "mode": "cached", "walk_s": walk_s,
                    "scatter_s": time.perf_counter() - t0 - walk_s,
                    "dirty_rows": 0, "blocks_rebuilt": 0, "rows": asm.W}
                return problem

        if mode is None:
            problem, changed, rescaled = self._patch_assembly(
                asm, spec, include_admitted)
            self.exports += 1
            # A unit-scale flip rewrites every quantity column, so the
            # changed-row positions no longer cover the diff — the
            # session must fall back to its full content diff.
            problem._columnar_hint = ColumnarHint(
                asm.seq, asm.seq - 1, rescaled, changed, "scatter",
                asm.W)
            self.last_stats = {
                "mode": "scatter", "walk_s": walk_s,
                "scatter_s": time.perf_counter() - t0 - walk_s,
                "dirty_rows": len(changed), "blocks_rebuilt": rebuilt,
                "rows": asm.W}
            return problem

        problem, asm = self._assemble(order, spec, stamp,
                                      include_admitted, afs)
        self.exports += 1
        label = "rebuild" if rebuilt == len(order) and order else "assemble"
        problem._columnar_hint = ColumnarHint(
            asm.seq, asm.seq - 1, True, {}, label, asm.W)
        self.last_stats = {
            "mode": label, "walk_s": walk_s,
            "scatter_s": time.perf_counter() - t0 - walk_s,
            "dirty_rows": 0, "blocks_rebuilt": rebuilt, "rows": asm.W}
        return problem

    def _bailout(self, reason: str, t0: float, walk_s: float):
        """An export handed back to the classic walk, counted by reason
        in ``bailouts`` and stamped into ``last_stats`` so the engine's
        export phase attributes the slower drain."""
        self.bailouts[reason] = self.bailouts.get(reason, 0) + 1
        self.last_stats = {
            "mode": f"bailout:{reason}", "walk_s": walk_s,
            "scatter_s": time.perf_counter() - t0 - walk_s,
            "dirty_rows": 0, "blocks_rebuilt": 0, "rows": 0}
        return None

    # -- cached path -------------------------------------------------------

    def _refresh_cached(self, asm: _Assembly, spec: dict):
        """Unchanged store: re-issue the cached problem, guarding the
        two pieces of shared interning that another export mode may
        have grown in between (the shape stack feeds the scale gcd; the
        token list is re-emitted verbatim as class_tok_root). Returns
        None when the gcd moved — the caller falls to the scatter path
        for a full rescale."""
        cache = self.cache
        if len(cache._shape_valid) != asm.stack_len:
            scale = self._scale_gcd(spec, asm.ad_usage_raw)
            if scale != asm.scale:
                return None
            asm.stack_len = len(cache._shape_valid)
        if len(cache._tok_root) != asm.tok_len:
            asm.problem = T.dataclasses.replace(
                asm.problem,
                class_tok_root=np.asarray(cache._tok_root,
                                          dtype=np.int32))
            asm.tok_len = len(cache._tok_root)
        asm.seq += 1
        return asm.problem

    # -- shared derivation helpers ----------------------------------------

    def _scale_gcd(self, spec: dict, ad_usage_raw: np.ndarray) -> int:
        usage0 = self._usage0(spec, self._nodes)
        scale = 0
        for arr in (spec["nominal"],
                    spec["borrow_limit"][spec["has_borrow"]],
                    usage0, spec["subtree"], spec["local_quota"],
                    self.cache.shape_matrices()[1], ad_usage_raw):
            flat = np.asarray(arr, dtype=np.int64).ravel()
            if flat.size:
                scale = math.gcd(scale, int(np.gcd.reduce(flat)))
        return max(scale, 1)

    @staticmethod
    def _scaled(a: np.ndarray, scale: int) -> np.ndarray:
        out = a // scale
        if out.size and out.max() >= T.MAX_QUANTITY:
            raise T.UnsupportedProblem(
                "quantities too large for int32 solver tensors")
        return out.astype(np.int32)

    def _class_densify(self, toks: np.ndarray, W: int, n_nodes: int):
        pos = toks >= 0
        if pos.any():
            uniq, inv_c = np.unique(toks[pos], return_inverse=True)
            n_classes = len(uniq)
            wl_class = np.full(W + 1, n_classes, dtype=np.int32)
            wl_class[np.nonzero(pos)[0]] = inv_c
            tok_root = np.asarray(self.cache._tok_root, dtype=np.int32)
            class_root = np.concatenate(
                [tok_root[uniq], [n_nodes]]).astype(np.int32)
        else:
            n_classes = 0
            wl_class = np.zeros(W + 1, dtype=np.int32)
            class_root = np.asarray([n_nodes], dtype=np.int32)
        return wl_class, class_root, n_classes

    def _ts_ranks(self, raw_ts_full: np.ndarray, W: int):
        wl_ts = np.zeros(W + 1, dtype=np.int32)
        wl_ts_buf = np.zeros(W + 1, dtype=np.int32)
        n_ts = 0
        if W:
            raw_ts = raw_ts_full[:W]
            distinct_ts, inv_ts = np.unique(raw_ts, return_inverse=True)
            n_ts = len(distinct_ts)
            wl_ts[:W] = inv_ts
            wl_ts_buf[:W] = T.ts_buffer_ranks(distinct_ts, raw_ts, inv_ts)
        return wl_ts, wl_ts_buf, n_ts

    def _node_fields(self, spec: dict, scale: int, usage0: np.ndarray):
        scaled = self._scaled
        return dict(
            nominal=scaled(spec["nominal"], scale),
            subtree=scaled(spec["subtree"], scale),
            local_quota=scaled(spec["local_quota"], scale),
            borrow_limit=np.where(
                spec["has_borrow"],
                scaled(spec["borrow_limit"], scale),
                T.BIG).astype(np.int32),
            usage0=scaled(usage0, scale))

    # -- scatter (patch) path ---------------------------------------------

    def _patch_assembly(self, asm: _Assembly, spec: dict,
                        include_admitted: bool):
        """Membership-stable re-export: copy-on-write only the columns
        whose rows moved, re-derive only the groups whose inputs moved.
        The returned problem aliases every unchanged array of the
        previous one."""
        cache = self.cache
        old = asm.problem
        W = asm.W
        n_nodes = spec["n_nodes"]

        # Changed rows since this assembly = its slice of the dirty
        # log, mapped home. Keys outside this mode's sections (e.g. an
        # admitted workload's event against the lean assembly) fall out
        # here — their effect rides the node usage rebuild below.
        changed: dict[str, int] = {}
        per_block: dict[tuple, list] = {}
        if asm.log_pos < len(self._log):
            for key in set(self._log[asm.log_pos:]):
                bk = self._key_home.get(key)
                if bk is None or bk not in asm.offsets:
                    continue
                blk = self._blocks.get(bk)
                idx = blk.pos().get(key) if blk is not None else None
                if idx is None:
                    continue
                changed[key] = asm.offsets[bk] + idx
                per_block.setdefault(bk, []).append(idx)

        fields: dict = {}
        ts_changed = tok_changed = shape_changed = False
        admit_changed = ad_usage_changed = False
        if changed:
            gpos = np.fromiter(changed.values(), np.int64, len(changed))
            wl_prio = old.wl_prio.copy()
            wl_uid = old.wl_uid.copy()
            wl_evicted0 = old.wl_evicted0.copy()
            wl_raw_ts = old.wl_raw_ts.copy()
            new_toks = asm.toks.copy()
            new_shapes = asm.shape_ids.copy()
            for bk, idxs in per_block.items():
                blk = self._blocks[bk]
                off = asm.offsets[bk]
                li = np.asarray(idxs, dtype=np.int64)
                gi = li + off
                wl_prio[gi] = blk.prio[li]
                wl_uid[gi] = blk.uid[li]
                wl_evicted0[gi] = blk.evicted[li]
                if not ts_changed and np.any(
                        wl_raw_ts[gi] != blk.raw_ts[li]):
                    ts_changed = True
                wl_raw_ts[gi] = blk.raw_ts[li]
                if not tok_changed and np.any(
                        new_toks[gi] != blk.class_tok[li]):
                    tok_changed = True
                new_toks[gi] = blk.class_tok[li]
                if not shape_changed and np.any(
                        new_shapes[gi] != blk.shape_id[li]):
                    shape_changed = True
                new_shapes[gi] = blk.shape_id[li]
            fields.update(wl_prio=wl_prio, wl_uid=wl_uid,
                          wl_evicted0=wl_evicted0, wl_raw_ts=wl_raw_ts)
            asm.toks = new_toks
            asm.shape_ids = new_shapes
            # Admitted rows additionally carry an admission timestamp
            # (ranked below) and an admission-usage row; patch both
            # from the freshly rebuilt block rows.
            wl_raw_admit_ts = old.wl_raw_admit_ts
            for bk, idxs in per_block.items():
                blk = self._blocks[bk]
                if blk.kind != "a":
                    continue
                off = asm.offsets[bk]
                for li in idxs:
                    gi = off + li
                    r = blk.rows[li]
                    if wl_raw_admit_ts[gi] != r.admit_ts:
                        if wl_raw_admit_ts is old.wl_raw_admit_ts:
                            wl_raw_admit_ts = \
                                old.wl_raw_admit_ts.copy()
                        wl_raw_admit_ts[gi] = r.admit_ts
                        admit_changed = True
                    dense = np.zeros(asm.ad_usage_raw.shape[1],
                                     dtype=np.int64)
                    if r.usage_fs is not None and r.usage_fs.size:
                        dense[r.usage_fs] = r.usage_qs
                    if np.any(asm.ad_usage_raw[gi] != dense):
                        asm.ad_usage_raw[gi] = dense
                        ad_usage_changed = True
            if admit_changed:
                raw_admit = wl_raw_admit_ts[asm.n_pending:asm.W]
                distinct_admit, inv_a = np.unique(
                    raw_admit, return_inverse=True)
                wl_admit_rank = old.wl_admit_rank.copy()
                wl_admit_rank[asm.n_pending:asm.W] = inv_a + 1
                asm.n_admit_rank = len(distinct_admit)
                fields.update(
                    wl_raw_admit_ts=wl_raw_admit_ts,
                    wl_admit_rank=wl_admit_rank,
                    admit_rank_base=len(distinct_admit) + 2)
        else:
            wl_raw_ts = old.wl_raw_ts

        # Node usage + unit scale track every store event, changed rows
        # or not (an admitted workload's release shifts usage0 without
        # touching any exported row of a lean problem).
        usage0 = self._usage0(spec, self._nodes)
        scale = self._scale_gcd(spec, asm.ad_usage_raw)
        rescale = scale != asm.scale
        if rescale or self._node_key_moved(asm):
            fields.update(self._node_fields(spec, scale, usage0))

        if shape_changed or rescale:
            stack_valid, stack_req = cache.shape_matrices()
            wl_valid = old.wl_valid.copy()
            wl_req_raw = np.zeros((W + 1, spec["K"], spec["F"]),
                                  dtype=np.int64)
            if W:
                wl_req_raw[:W] = stack_req[asm.shape_ids]
                wl_valid[:W] = stack_valid[asm.shape_ids]
            fields["wl_req"] = self._scaled(wl_req_raw, scale)
            fields["wl_valid"] = wl_valid
        if include_admitted and (rescale or ad_usage_changed):
            fields["ad_usage"] = self._scaled(asm.ad_usage_raw, scale)

        if ts_changed:
            wl_ts, wl_ts_buf, n_ts = self._ts_ranks(wl_raw_ts, W)
            fields.update(wl_ts=wl_ts, wl_ts_buf=wl_ts_buf,
                          ts_evict_base=n_ts + 1)
            asm.n_ts = n_ts
        if tok_changed:
            wl_class, class_root, n_classes = self._class_densify(
                asm.toks, W, n_nodes)
            fields.update(
                wl_class=wl_class, class_root=class_root,
                n_classes=n_classes,
                wl_class_tok=np.concatenate(
                    [asm.toks, [-1]]).astype(np.int64))
            asm.n_classes = n_classes
        if len(cache._tok_root) != asm.tok_len:
            fields["class_tok_root"] = np.asarray(cache._tok_root,
                                                  dtype=np.int32)
            asm.tok_len = len(cache._tok_root)

        if fields:
            asm.problem = T.dataclasses.replace(old, **fields,
                                                scale=scale)
        asm.scale = scale
        asm.stack_len = len(cache._shape_valid)
        asm.snap_mark = self._snap_mark
        asm.log_pos = len(self._log)
        asm.seq += 1
        return asm.problem, changed, rescale

    def _node_key_moved(self, asm: _Assembly) -> bool:
        return asm.snap_mark != self._snap_mark

    # -- assemble path -----------------------------------------------------

    def _assemble(self, order: list, spec: dict, stamp: tuple,
                  include_admitted: bool, afs):
        """Concatenate block columns and run the vectorized tail of the
        classic walk. O(W) numpy, no per-row Python (changed blocks
        were already rebuilt)."""
        cache = self.cache
        blocks = [self._blocks[bk] for bk in order]
        sizes = [len(b.keys) for b in blocks]
        offsets: dict[tuple, int] = {}
        off = 0
        n_heap = n_pending = 0
        for bk, b, sz in zip(order, blocks, sizes):
            offsets[bk] = off
            off += sz
            if b.kind == "h":
                n_heap += sz
            if b.kind in ("h", "p"):
                n_pending += sz
        W = off
        C = spec["C"]
        K, F = spec["K"], spec["F"]
        n_nodes = spec["n_nodes"]

        cids = _concat([b.cids for b in blocks], np.int32)
        ranks = _concat(
            [np.arange(sz, dtype=np.int32) if b.kind == "h"
             else np.full(sz, int(T.BIG), dtype=np.int32)
             for b, sz in zip(blocks, sizes)], np.int32)
        wl_cqid = np.concatenate([cids, [C]]).astype(np.int32)
        wl_rank = np.concatenate([ranks, [T.BIG]]).astype(np.int32)

        wl_prio = np.zeros(W + 1, dtype=np.int32)
        wl_uid = np.zeros(W + 1, dtype=np.int32)
        wl_req = np.zeros((W + 1, K, F), dtype=np.int64)
        wl_valid = np.zeros((W + 1, K), dtype=bool)
        wl_admitted0 = np.zeros(W + 1, dtype=bool)
        wl_admitted0[n_pending:W] = True
        wl_parked0 = np.zeros(W + 1, dtype=bool)
        wl_parked0[n_heap:n_pending] = True
        wl_evicted0 = np.zeros(W + 1, dtype=bool)
        wl_admit_rank = np.zeros(W + 1, dtype=np.int32)
        ad_usage_raw = np.zeros((W + 1, F), dtype=np.int64)

        shape_ids = _concat([b.shape_id for b in blocks], np.int64)
        toks = _concat([b.class_tok for b in blocks], np.int64)
        wl_raw_ts = np.zeros(W + 1, dtype=np.float64)
        wl_raw_admit_ts = np.zeros(W + 1, dtype=np.float64)
        stack_valid, stack_req = cache.shape_matrices()
        if W:
            wl_prio[:W] = _concat([b.prio for b in blocks], np.int64)
            wl_uid[:W] = _concat([b.uid for b in blocks], np.int64)
            wl_evicted0[:W] = _concat([b.evicted for b in blocks], bool)
            wl_valid[:W] = stack_valid[shape_ids]
            wl_req[:W] = stack_req[shape_ids]
            wl_raw_ts[:W] = _concat([b.raw_ts for b in blocks],
                                    np.float64)

        wl_class, class_root, n_classes = self._class_densify(
            toks, W, n_nodes)
        wl_ts, wl_ts_buf, n_ts = self._ts_ranks(wl_raw_ts, W)

        n_admit_rank = 0
        if W > n_pending:
            admitted = [b for b in blocks if b.kind == "a"]
            raw_admit = _concat([b.admit_ts for b in admitted],
                                np.float64)
            wl_raw_admit_ts[n_pending:W] = raw_admit
            distinct_admit, inv_a = np.unique(raw_admit,
                                              return_inverse=True)
            n_admit_rank = len(distinct_admit)
            wl_admit_rank[n_pending:W] = inv_a + 1
            for bk, b in zip(order, blocks):
                if b.kind == "a" and b.u_rows.size:
                    ad_usage_raw[offsets[bk] + b.u_rows, b.u_fs] = b.u_qs

        usage0 = self._usage0(spec, self._nodes)
        scale = self._scale_gcd(spec, ad_usage_raw)
        scaled = self._scaled
        node_fields = self._node_fields(spec, scale, usage0)

        cq_afs = (spec["cq_afs_spec"] if afs is not None
                  else spec["cq_afs_zero"])
        wl_keys: list[str] = []
        for b in blocks:
            wl_keys.extend(b.keys)

        problem = T.SolverProblem(
            parent=spec["parent"],
            depth=spec["depth"],
            height=spec["height"],
            has_parent=spec["has_parent"],
            path=spec["path"],
            nominal=node_fields["nominal"],
            subtree=node_fields["subtree"],
            local_quota=node_fields["local_quota"],
            has_borrow=spec["has_borrow"],
            borrow_limit=node_fields["borrow_limit"],
            usage0=node_fields["usage0"],
            cq_node=spec["cq_node"],
            cq_strict=spec["cq_strict"],
            cq_try_next=spec["cq_try_next"],
            cq_root_height=spec["cq_root_height"],
            cq_nflavors=spec["cq_nflavors"],
            wl_cqid=wl_cqid,
            wl_rank=wl_rank,
            wl_prio=wl_prio,
            wl_ts=wl_ts,
            wl_uid=wl_uid,
            wl_req=scaled(wl_req, scale),
            wl_valid=wl_valid,
            wl_parked0=wl_parked0,
            wl_admitted0=wl_admitted0,
            wl_evicted0=wl_evicted0,
            wl_admit_rank=wl_admit_rank,
            ad_usage=scaled(ad_usage_raw, scale),
            cq_within_policy=spec["cq_within_policy"],
            cq_reclaim_policy=spec["cq_reclaim_policy"],
            cq_bwc_forbidden=spec["cq_bwc_forbidden"],
            cq_bwc_threshold=spec["cq_bwc_threshold"],
            cq_preempt_try_next=spec["cq_preempt_try_next"],
            cq_pref_pob=spec["cq_pref_pob"],
            cq_fair_weight=spec["cq_fair_weight"],
            cq_root=spec["cq_root"],
            cq_opt_group=spec["cq_opt_group"],
            cq_ngroups=spec["cq_ngroups"],
            fr_resource=spec["fr_resource"],
            node_fair_weight=spec["node_fair_weight"],
            wl_class=wl_class,
            class_root=class_root,
            n_classes=n_classes,
            wl_lq=np.zeros(W + 1, dtype=np.int32),
            wl_afs_penalty=np.zeros(W + 1, dtype=np.float32),
            wl_ts_buf=wl_ts_buf,
            lq_penalty0=np.asarray([0.0], dtype=np.float32),
            cq_afs=cq_afs,
            wl_raw_ts=wl_raw_ts,
            wl_raw_admit_ts=wl_raw_admit_ts,
            wl_class_tok=np.concatenate([toks, [-1]]).astype(np.int64),
            class_tok_root=np.asarray(cache._tok_root, dtype=np.int32),
            n_resources=spec["n_resources"],
            ts_evict_base=n_ts + 1,
            admit_rank_base=n_admit_rank + 2,
            fr_list=list(spec["fr_list"]),
            node_names=spec["node_names"],
            cq_names=spec["cq_names"],
            wl_keys=wl_keys,
            cq_option_flavors=spec["cq_option_flavors"],
            cq_resource_group=spec["cq_resource_group"],
            scale=scale,
        )

        prev = self._asms.get(include_admitted)
        asm = _Assembly()
        asm.order = list(order)
        asm.build_seqs = {bk: self._blocks[bk].member_seq for bk in order}
        asm.log_pos = len(self._log)
        asm.log_epoch = self._log_epoch
        asm.stamp = stamp
        asm.snap_mark = self._snap_mark
        asm.stack_len = len(cache._shape_valid)
        asm.tok_len = len(cache._tok_root)
        asm.scale = scale
        asm.problem = problem
        asm.seq = (prev.seq + 1) if prev is not None else 1
        asm.offsets = offsets
        asm.n_heap = n_heap
        asm.n_pending = n_pending
        asm.W = W
        asm.toks = toks
        asm.shape_ids = shape_ids
        asm.ad_usage_raw = ad_usage_raw
        asm.n_ts = n_ts
        asm.n_admit_rank = n_admit_rank
        asm.n_classes = n_classes
        self._asms[include_admitted] = asm
        return problem, asm


def _concat(parts: list, dtype) -> np.ndarray:
    arrs = [p for p in parts if len(p)]
    if not arrs:
        return np.zeros(0, dtype=dtype)
    return np.concatenate(arrs).astype(dtype, copy=False)
