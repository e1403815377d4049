"""Worker-nomination dispatchers.

A copy of ``kueue_oss_tpu/multikueue/dispatcher.py`` (reference:
pkg/controller/workloaddispatcher). AllAtOnce nominates every active
worker at once; Incremental nominates up to 3 new workers a round and
opens the next round after a timeout without admission
(incrementaldispatcher.go:130-197). WhatIf prices the candidates with
one batched what-if drain on the device (``sim/dispatch.py``) and
nominates only the predicted-best worker, degrading to Incremental
whenever the pricer cannot speak for a cluster.

``WhatIfDispatcher`` keeps plain counters (``counts``: scored /
deferred / fallback rounds, equal to
``kueue_multikueue_whatif_dispatch_total``) and the pricing times
(``score_ms``, observed in ``kueue_multikueue_dispatch_score_ms``), and
records every exception the pricer
raised (``faults``: kind and message). A pricer fault still degrades
to Incremental, as in the JAX package, so something is nominated
while workers remain; but it is a fault, never a silent fallback: an
unpriceable cluster is reported inside the ``DispatchReport`` and
raises nothing, so ``faults`` stays empty unless the pricer itself
failed (a device or launch error). The JAX constructor's ``clock`` is
cut (no caller passes one): the score times read ``time.monotonic``.
"""

from __future__ import annotations

import time
from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.api.types import Workload

DISPATCHER_ALL_AT_ONCE = "AllAtOnce"
DISPATCHER_INCREMENTAL = "Incremental"
DISPATCHER_WHAT_IF = "WhatIf"

INCREMENTAL_WORKERS_PER_ROUND = 3
INCREMENTAL_ROUND_TIMEOUT_S = 300.0


class AllAtOnceDispatcher:
    name = DISPATCHER_ALL_AT_ONCE

    def nominate(self, wl: Workload, clusters: list[str],
                 now: float) -> list[str]:
        return [c for c in clusters
                if c not in wl.status.nominated_cluster_names]


class IncrementalDispatcher:
    name = DISPATCHER_INCREMENTAL

    def __init__(self,
                 per_round: int = INCREMENTAL_WORKERS_PER_ROUND,
                 round_timeout_s: float = INCREMENTAL_ROUND_TIMEOUT_S) -> None:
        self.per_round = per_round
        self.round_timeout_s = round_timeout_s
        self._round_start: dict[str, float] = {}

    def nominate(self, wl: Workload, clusters: list[str],
                 now: float) -> list[str]:
        nominated = wl.status.nominated_cluster_names
        remaining = [c for c in clusters if c not in nominated]
        if not remaining:
            return []
        started = self._round_start.get(wl.key)
        if nominated and started is not None:
            if now - started < self.round_timeout_s:
                return []  # current round still racing
        self._round_start[wl.key] = now
        return remaining[:self.per_round]

    def clear(self, wl_key: str) -> None:
        self._round_start.pop(wl_key, None)


class WhatIfDispatcher:
    """Counterfactually priced nomination.

    For each workload round, one batched what-if drain on ``device``
    scores every active candidate ("the workload lands on cluster k")
    and the single best-scoring worker is nominated. A round that fails
    to admit re-prices after ``round_timeout_s`` against the remaining
    candidates. When the pricer cannot score (FULL-drain shapes, TAS,
    a pricer fault, no environments bound) the round degrades to an
    internal IncrementalDispatcher.

    The controller calls ``bind(clusters)`` at construction so the
    dispatcher reaches the worker environments; ``nominate``'s
    signature stays its siblings'.
    """

    name = DISPATCHER_WHAT_IF

    def __init__(self,
                 round_timeout_s: float = INCREMENTAL_ROUND_TIMEOUT_S,
                 check_oracle: bool = False, device="cuda") -> None:
        self.round_timeout_s = round_timeout_s
        self.check_oracle = check_oracle
        self.device = device
        self._clusters: dict = {}
        self._round_start: dict[str, float] = {}
        self._fallback = IncrementalDispatcher(
            round_timeout_s=round_timeout_s)
        #: last DispatchReport per workload key
        self.last_reports: dict[str, object] = {}
        #: rounds by outcome (the JAX package's
        #: multikueue_whatif_dispatch_total)
        self.counts = {"scored": 0, "deferred": 0, "fallback": 0}
        #: the wall of every pricing call, ms (its
        #: multikueue_dispatch_score_ms)
        self.score_ms: list[float] = []
        #: (exception kind, message) of every pricer fault
        self.faults: list[tuple[str, str]] = []

    def bind(self, clusters: dict) -> None:
        """Controller wiring: name -> MultiKueueCluster."""
        self._clusters = clusters

    def nominate(self, wl: Workload, clusters: list[str],
                 now: float) -> list[str]:
        nominated = wl.status.nominated_cluster_names
        remaining = [c for c in clusters if c not in nominated]
        if not remaining:
            return []
        started = self._round_start.get(wl.key)
        if nominated and started is not None:
            if now - started < self.round_timeout_s:
                self.counts["deferred"] += 1
                metrics.multikueue_whatif_dispatch_total.inc("deferred")
                return []  # current round still racing
        best = self._price(wl, remaining, now)
        if best is None:
            self.counts["fallback"] += 1
            metrics.multikueue_whatif_dispatch_total.inc("fallback")
            # keep the fallback's round clock coherent with ours
            picked = self._fallback.nominate(wl, remaining, now)
            if picked:
                self._round_start[wl.key] = now
            return picked
        self.counts["scored"] += 1
        metrics.multikueue_whatif_dispatch_total.inc("scored")
        self._round_start[wl.key] = now
        return [best]

    def _price(self, wl: Workload, remaining: list[str],
               now: float) -> Optional[str]:
        envs = {}
        for name in remaining:
            cluster = self._clusters.get(name)
            if cluster is not None and cluster.active:
                envs[name] = cluster.environment
        if not envs:
            return None
        from kueue_oss_tpu_torch.sim.dispatch import price_dispatch

        t0 = time.monotonic()
        try:
            report = price_dispatch(wl, envs, now=now,
                                    check_oracle=self.check_oracle,
                                    device=self.device)
        except Exception as e:  # noqa: BLE001 - degrade, and record it
            self.faults.append((type(e).__name__, str(e)))
            return None
        finally:
            self.score_ms.append((time.monotonic() - t0) * 1e3)
            metrics.multikueue_dispatch_score_ms.observe(
                value=self.score_ms[-1])
        self.last_reports[wl.key] = report
        return report.best

    def clear(self, wl_key: str) -> None:
        self._round_start.pop(wl_key, None)
        self._fallback.clear(wl_key)
