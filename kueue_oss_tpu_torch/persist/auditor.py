"""Invariant auditor: recompute admission accounting, diff the store.

A copy of ``kueue_oss_tpu/persist/auditor.py``, background thread
included.

The control plane's accounting (the store's admitted index, the
snapshot forest's per-CQ usage, cohort subtree rollups) is DERIVED
state — the durable truth is the admission records on the workloads
themselves. After a recovery, a leader failover, or simply months of
churn, the two can drift (a missed index update, a replayed event
applied twice, a bug). The auditor recomputes everything derivable
from the admitted workloads via the ``core/quota.py`` formulas and
diffs it against what the store's accounting path reports:

  admitted_index    -- Store._admitted vs the reserved-and-not-finished
                       predicate over the workloads dict
  finished_tracking -- Store._finished_counted vs the FINISHED condition
  usage_mismatch    -- per-CQ (flavor, resource) usage summed from
                       admission.podset_assignments.resource_usage vs
                       the snapshot forest built from store accounting
  cohort_usage      -- cohort-node usage after the bottom-up
                       QuotaForest.refresh rollup, both sides
  subtree_quota     -- cohort/CQ subtree quota, both sides
  admission_ref     -- an admitted workload charging a ClusterQueue
                       that no longer exists
  podset_mismatch   -- admission podset assignments not matching the
                       workload's podsets

Each violation bumps ``kueue_invariant_violations_total{check}``.
``auto_heal`` rebuilds the store's derived indexes from the workloads
dict (the only safe rebuild — spec/usage divergence is reported, never
silently rewritten) and re-audits.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.core.quota import QuotaForest
from kueue_oss_tpu_torch.core.store import Store


@dataclass
class Violation:
    check: str
    subject: str  # workload key / CQ / cohort the violation hangs on
    detail: str = ""
    expected: object = None
    actual: object = None

    def to_dict(self) -> dict:
        return {"check": self.check, "subject": self.subject,
                "detail": self.detail,
                "expected": repr(self.expected),
                "actual": repr(self.actual)}


def _nonzero(usage: dict) -> dict:
    return {fr: v for fr, v in usage.items() if v}


def recompute_cq_usage(store: Store) -> dict[str, dict]:
    """Per-CQ (flavor, resource) usage from the admission records of
    every reserved-and-not-finished workload — the durable ground
    truth, independent of any index or cache.

    Reclaimable pods release their share of a running admission
    (workload_info applies status.reclaimablePods when building usage),
    so the recompute scales each podset's recorded usage by the still-
    held pod count — the same ``scaled_to`` arithmetic, applied to the
    admission record instead of the cached info."""
    from kueue_oss_tpu_torch import features

    reclaim_on = features.enabled("ReclaimablePods")
    usage: dict[str, dict] = {}
    for wl in store.workloads.values():
        if not wl.is_quota_reserved or wl.is_finished:
            continue
        adm = wl.status.admission
        if adm is None:
            continue
        rp = wl.status.reclaimable_pods if reclaim_on else {}
        cq = usage.setdefault(adm.cluster_queue, {})
        for psa in adm.podset_assignments:
            reclaimed = rp.get(psa.name, 0) if rp else 0
            for resource, qty in psa.resource_usage.items():
                flavor = psa.flavors.get(resource)
                if flavor is None:
                    continue
                if reclaimed and psa.count:
                    qty = (qty // psa.count) * max(
                        0, psa.count - reclaimed)
                fr = (flavor, resource)
                cq[fr] = cq.get(fr, 0) + qty
    return usage


class InvariantAuditor:
    """Audit on demand or on a background cadence."""

    def __init__(self, store: Store, auto_heal: bool = False) -> None:
        self.store = store
        self.auto_heal = auto_heal
        self.last_violations: list[Violation] = []
        self.audits_run = 0
        self.heals_run = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one audit pass ----------------------------------------------------

    def audit(self) -> list[Violation]:
        # The pass holds the store lock (an RLock, so the snapshot/info
        # paths that re-enter it are fine) so dict iteration never
        # races a store write. The lock is NOT sufficient against the
        # scheduler's in-place object mutations (conditions flip before
        # update_workload takes the lock), which is why the background
        # cadence uses audit_confirmed() — a violation must survive two
        # consecutive passes before it is reported or healed.
        with self.store._lock:
            out = self._audit_locked()
        return self._finish(out)

    def audit_confirmed(self) -> list[Violation]:
        """Two-pass audit for concurrent callers: only violations that
        indict the same (check, subject) in BOTH passes survive.

        A scheduler thread mutates workload objects in place before
        the store write lands, so a single pass can catch a torn
        half-written decision and indict a healthy store; the window
        is microseconds, so any such phantom resolves by the second
        pass. Real drift is persistent and survives both."""
        with self.store._lock:
            first = {(v.check, v.subject) for v in self._audit_locked()}
        if not first:
            return self._finish([])
        with self.store._lock:
            second = self._audit_locked()
        return self._finish(
            [v for v in second if (v.check, v.subject) in first])

    def _audit_locked(self) -> list[Violation]:
        out: list[Violation] = []
        store = self.store
        workloads = dict(store.workloads)
        indexed = set(store._admitted)
        finished_counted = set(store._finished_counted)

        expected_admitted = {
            k for k, wl in workloads.items()
            if wl.is_quota_reserved and not wl.is_finished}
        for k in sorted(expected_admitted - indexed):
            out.append(Violation(
                "admitted_index", k,
                "reserved workload missing from the admitted index"))
        for k in sorted(indexed - expected_admitted):
            out.append(Violation(
                "admitted_index", k,
                "admitted index holds a non-reserved workload"))

        expected_finished = {
            k for k, wl in workloads.items() if wl.is_finished}
        for k in sorted(expected_finished ^ finished_counted):
            out.append(Violation(
                "finished_tracking", k,
                "FINISHED condition and the finished-transition set "
                "disagree",
                expected=k in expected_finished,
                actual=k in finished_counted))

        for k, wl in sorted(workloads.items()):
            adm = wl.status.admission
            if adm is None or not wl.is_quota_reserved:
                continue
            if adm.cluster_queue not in store.cluster_queues:
                out.append(Violation(
                    "admission_ref", k,
                    f"admission charges missing ClusterQueue "
                    f"{adm.cluster_queue!r}"))
            ps_names = [ps.name for ps in wl.podsets]
            psa_names = [psa.name for psa in adm.podset_assignments]
            if sorted(ps_names) != sorted(psa_names):
                out.append(Violation(
                    "podset_mismatch", k,
                    "admission podset assignments do not cover the "
                    "workload's podsets",
                    expected=ps_names, actual=psa_names))

        # ground truth vs store accounting: same quota formulas, two
        # input paths — admission records vs the admitted-info cache
        truth_usage = recompute_cq_usage(store)
        truth = QuotaForest()
        try:
            truth.build(store.cluster_queues.values(),
                        store.cohorts.values(),
                        cq_usage={cq: u for cq, u in truth_usage.items()
                                  if cq in store.cluster_queues})
        except Exception as e:
            out.append(Violation("forest_build", "-", str(e)))
            return out
        from kueue_oss_tpu_torch.core.snapshot import build_snapshot

        # the forest is all the audit reads: the snapshot's TAS trees
        # run no fill here, so their device is immaterial
        accounted = build_snapshot(store, device="cpu").forest
        for name, node in sorted(truth.cqs.items()):
            acc = accounted.cqs.get(name)
            acc_usage = _nonzero(acc.usage) if acc is not None else {}
            if _nonzero(node.usage) != acc_usage:
                out.append(Violation(
                    "usage_mismatch", name,
                    "per-CQ usage recomputed from admission records "
                    "disagrees with store accounting",
                    expected=_nonzero(node.usage), actual=acc_usage))
        for key, node in sorted(truth.nodes.items()):
            if node.is_cq:
                continue
            acc = accounted.nodes.get(key)
            if acc is None:
                out.append(Violation(
                    "cohort_usage", key,
                    "cohort present in recompute but not in accounting"))
                continue
            if _nonzero(node.usage) != _nonzero(acc.usage):
                out.append(Violation(
                    "cohort_usage", key,
                    "cohort usage rollup disagrees",
                    expected=_nonzero(node.usage),
                    actual=_nonzero(acc.usage)))
            if _nonzero(node.subtree_quota) != _nonzero(acc.subtree_quota):
                out.append(Violation(
                    "subtree_quota", key,
                    "cohort subtree quota disagrees",
                    expected=_nonzero(node.subtree_quota),
                    actual=_nonzero(acc.subtree_quota)))
        return out

    def _finish(self, out: list[Violation]) -> list[Violation]:
        self.audits_run += 1
        metrics.invariant_audits_total.inc()
        for v in out:
            metrics.invariant_violations_total.inc(v.check)
        metrics.invariant_last_violations.set(value=len(out))
        self.last_violations = out
        if out and self.auto_heal and self.heal():
            # post-heal re-check: what remains is spec/usage divergence
            # a rebuild cannot fix. Refresh the gauge and the public
            # list, but do NOT re-increment the counters — that would
            # count one incident twice per pass.
            with self.store._lock:
                out = self._audit_locked()
            metrics.invariant_last_violations.set(value=len(out))
            self.last_violations = out
        return out

    def heal(self) -> bool:
        """Rebuild the derived indexes from the workloads dict. Returns
        True when a heal ran (index-class violations present)."""
        if not any(v.check in ("admitted_index", "finished_tracking",
                               "usage_mismatch")
                   for v in self.last_violations):
            return False
        from kueue_oss_tpu_torch.persist.codec import rebuild_indexes

        with self.store._lock:
            rebuild_indexes(self.store)
        self.heals_run += 1
        metrics.invariant_heals_total.inc()
        return True

    # -- background cadence ------------------------------------------------

    def start(self, interval_s: float = 60.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.audit_confirmed()
                except Exception:
                    # the auditor observes; it must never take the
                    # control plane down with it. An internal crash is
                    # an auditor defect, not state drift — it must not
                    # pollute the "must stay 0" violations series.
                    metrics.invariant_audit_errors_total.inc()

        self._thread = threading.Thread(
            target=loop, name="kueue-invariant-auditor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
