"""Multi-tenant solver farm: weighted DRR admission over solver wall-time.

A copy of ``kueue_oss_tpu/federation/farm.py``: N control planes share
ONE solver sidecar on the card. Each control plane
is a *tenant*: its ``SolverClient`` stamps a tenant id into every frame
header, the sidecar keys resident sessions ``(tenant, sid)`` (service.py),
and this module arbitrates who gets the solver next.

The scheduler is a weighted deficit round robin (DRR) over solver
WALL-TIME, not request count — one tenant's 50 ms full solves must not
buy it 10x the farm share of a neighbor's 5 ms lean solves:

- each tenant owns a FIFO queue of waiting requests and a deficit
  counter in seconds;
- a grant opportunity walks the tenant ring from the rotating cursor;
  every backlogged tenant visited accrues ``quantum_s * weight``; the
  first whose deficit goes positive is granted (the walk is computed in
  closed form — O(tenants), not O(rounds));
- the granted request's ACTUAL wall-time is charged afterwards, so the
  deficit can go negative: an expensive solve is a debt the tenant
  pays off by waiting out its neighbors' quanta;
- a tenant with an empty queue forfeits its credit (deficit resets to
  0) — idle time is not bankable, exactly like classic DRR;
- positive credit is capped at ``max_credit_quanta`` quanta so a
  lightly-loaded tenant cannot hoard an unbounded burst.

Backpressure is the contract that keeps a starved tenant from wedging:
a tenant with ``max_queued`` requests already waiting gets an IN-BAND
error (``{"ok": false, "error": "...backpressure..."}``) instead of a
queue slot. The client collapses that into ``SolverUnavailable``, the
engine's breaker trips, and the control plane degrades to host cycles —
it keeps scheduling, just without the accelerator, and re-probes later.

One executor slot: the underlying solver is one device — running two
tenants' solves concurrently would just interleave their launches. The
DRR therefore serializes solve bodies; fairness comes from the grant
ORDER, not parallelism. A body takes the sidecar's device lock
(``service._DEVICE_LOCK``) inside the slot, never the other way round,
and the wall charged is the body's, lock wait included.

The farm series of the metrics registry (requests, wall seconds,
throttles, tenants, the grant-wait histogram) equal the plain ledgers
``wall_by_tenant``, ``served``, ``throttled`` and the tenant ring, and
with a ``tracer`` set every grant stamps a ``farm_grant_wait`` span on
a per-tenant farm track (the service's response carries the same span
to the client). A throttle raises the degradation ladder's FEDERATION
``backpressure`` condition and a served grant clears it.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Optional

from kueue_oss_tpu_torch import metrics, resilience


def _backpressure(tenant: str, why: str) -> tuple[dict, bytes]:
    """The in-band throttle answer. Deliberately NOT a resync: the
    client must degrade via SolverUnavailable (host cycles), not burn
    the farm's time re-SYNCing a session that is perfectly healthy."""
    return {"ok": False,
            "error": f"solver farm backpressure for tenant "
                     f"{tenant!r}: {why}"}, b""


class _Ticket:
    __slots__ = ("granted",)

    def __init__(self) -> None:
        self.granted = threading.Event()


#: the handler thread that called run() also runs fn() and builds the
#: response, so the grant-wait it just paid rides a thread-local out to
#: the service layer (the response header's grant_wait_ms field)
_tls = threading.local()


def last_grant_wait_s() -> float:
    """Grant-wait of the newest farm admission on THIS thread (0.0
    when the thread never went through a farm)."""
    return getattr(_tls, "grant_wait_s", 0.0)


class FarmScheduler:
    """Weighted deficit-round-robin admission over solver wall-time.

    ``run(tenant, fn)`` is the only entry point the sidecar uses: it
    enqueues, waits for its DRR grant, times ``fn()``, charges the
    wall-time, and hands the slot to the next winner. Attach to a
    ``SolverServer`` with :func:`attach_farm` (or ``server.farm = ...``).

    ``clock`` is injectable so tests drive fairness deterministically.
    """

    def __init__(self,
                 weights: Optional[dict[str, float]] = None,
                 default_weight: float = 1.0,
                 quantum_s: float = 0.025,
                 max_queued: int = 8,
                 max_credit_quanta: float = 4.0,
                 grant_timeout_s: float = 600.0,
                 clock=time.monotonic) -> None:
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self.quantum_s = float(quantum_s)
        self.max_queued = max(1, int(max_queued))
        self.max_credit_quanta = float(max_credit_quanta)
        self.grant_timeout_s = float(grant_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._queues: dict[str, deque[_Ticket]] = {}
        self._ring: list[str] = []
        self._cursor = 0
        self._deficit: dict[str, float] = {}
        self._busy = False
        #: optional debugger.profiling.Tracer — when set, every grant
        #: stamps a "farm_grant_wait" span on a per-tenant farm track
        self.tracer = None
        #: per-tenant ledgers (the metrics registry carries the same
        #: totals)
        self.wall_by_tenant: dict[str, float] = {}
        self.served: dict[str, int] = {}
        self.throttled: dict[str, int] = {}
        #: chaos seam (force_throttle): tenant ->
        #: remaining run() calls to answer with forced backpressure
        self.throttle_fault: dict[str, int] = {}

    @classmethod
    def from_config(cls, cfg, clock=time.monotonic) -> "FarmScheduler":
        """Build from a ``config.FederationConfig``."""
        return cls(weights=dict(cfg.tenant_weights),
                   default_weight=cfg.default_weight,
                   quantum_s=cfg.quantum_seconds,
                   max_queued=cfg.max_queued,
                   max_credit_quanta=cfg.max_credit_quanta,
                   clock=clock)

    # -- accounting --------------------------------------------------------

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(self.weights.get(tenant,
                                                self.default_weight)))

    def set_weights(self, weights: Optional[dict] = None,
                    default_weight: Optional[float] = None) -> dict:
        """Runtime re-weighting.

        Takes effect within ONE ring walk: the closed-form grant walk
        reads :meth:`weight` live for every visit computation, so the
        very next grant opportunity accrues at the new rates — no
        queue drain, no ring rebuild, and standing deficits (debt from
        already-charged solves) are preserved. Positive credit is
        re-capped against the new weights. Returns the effective map.

        Raises ValueError on a non-positive or non-finite weight: a
        zero weight would starve a tenant silently (use admission
        policy for that), and ``weight()``'s 1e-9 clamp would mask
        the operator's typo instead of rejecting it.
        """
        with self._lock:
            if weights is not None:
                parsed = {str(k): float(v) for k, v in weights.items()}
                for t, w in parsed.items():
                    if not (w > 0.0) or math.isinf(w):
                        raise ValueError(
                            f"weight for {t!r} must be finite and > 0, "
                            f"got {w}")
                self.weights = parsed
            if default_weight is not None:
                dw = float(default_weight)
                if not (dw > 0.0) or math.isinf(dw):
                    raise ValueError(
                        f"defaultWeight must be finite and > 0, got {dw}")
                self.default_weight = dw
            for t in self._ring:
                cap = (self.quantum_s * self.weight(t)
                       * self.max_credit_quanta)
                if self._deficit.get(t, 0.0) > cap:
                    self._deficit[t] = cap
            return dict(self.weights)

    def reload_config(self, cfg) -> dict:
        """Hot-reload the DRR knobs from a ``config.FederationConfig``
        (the /api/farm/weights surface and SIGHUP-style reloads)."""
        with self._lock:
            self.quantum_s = float(cfg.quantum_seconds)
            self.max_queued = max(1, int(cfg.max_queued))
            self.max_credit_quanta = float(cfg.max_credit_quanta)
        return self.set_weights(dict(cfg.tenant_weights),
                                cfg.default_weight)

    def force_throttle(self, tenant: str, times: int = 1) -> None:
        """Chaos seam: the next ``times`` run() calls for ``tenant``
        answer with in-band backpressure as if the farm were
        partitioned away — the client degrades to host cycles exactly
        like real starvation."""
        with self._lock:
            self.throttle_fault[str(tenant)] = (
                self.throttle_fault.get(str(tenant), 0) + max(1, times))

    def stats(self) -> dict[str, dict[str, float]]:
        with self._lock:
            tenants = set(self.wall_by_tenant) | set(self.throttled)
            return {t: {"wall_s": self.wall_by_tenant.get(t, 0.0),
                        "served": self.served.get(t, 0),
                        "throttled": self.throttled.get(t, 0)}
                    for t in tenants}

    # -- the DRR core ------------------------------------------------------

    def _register_locked(self, tenant: str) -> None:
        if tenant not in self._queues:
            self._queues[tenant] = deque()
            self._ring.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
            metrics.solver_farm_tenants.set(value=len(self._ring))

    def _grant_next_locked(self) -> None:
        """Pick the next winner by simulating the ring walk in closed
        form: for each backlogged tenant, the number of quantum visits
        it needs before its deficit goes positive; the winner is the
        fewest-visits tenant, ring order from the cursor breaking ties.
        Every backlogged tenant then accrues the winner's visit count
        (that is exactly what walking the ring that many times would
        have paid out), so relative credit is preserved."""
        if self._busy:
            return
        n = len(self._ring)
        backlogged = [(i, t) for i, t in enumerate(self._ring)
                      if self._queues[t]]
        if not backlogged:
            return
        # idle tenants forfeit credit — DRR's "no banking" rule
        for t in self._ring:
            if not self._queues[t] and self._deficit.get(t, 0.0) > 0:
                self._deficit[t] = 0.0

        def visits_needed(t: str) -> int:
            d = self._deficit.get(t, 0.0)
            if d > 0:
                return 0
            per = self.quantum_s * self.weight(t)
            return int(-d / per) + 1

        best = None
        for i, t in backlogged:
            need = visits_needed(t)
            pos = (i - self._cursor) % n  # ring distance from cursor
            key = (need, pos)
            if best is None or key < best[0]:
                best = (key, i, t)
        (rounds, _), idx, winner = best
        if rounds:
            for _, t in backlogged:
                cap = (self.quantum_s * self.weight(t)
                       * self.max_credit_quanta)
                self._deficit[t] = min(
                    self._deficit.get(t, 0.0)
                    + rounds * self.quantum_s * self.weight(t), cap)
        self._cursor = (idx + 1) % n
        self._busy = True
        ticket = self._queues[winner].popleft()
        ticket.granted.set()

    def _complete(self, tenant: str, wall_s: float) -> None:
        with self._lock:
            self._busy = False
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) - wall_s
            self.wall_by_tenant[tenant] = (
                self.wall_by_tenant.get(tenant, 0.0) + wall_s)
            self.served[tenant] = self.served.get(tenant, 0) + 1
            # under the lock, so the series sums in the ledger's order
            metrics.solver_farm_wall_seconds_total.inc(tenant, by=wall_s)
            self._grant_next_locked()

    # -- entry point -------------------------------------------------------

    def run(self, tenant: str, fn: Callable[[], tuple[dict, bytes]]
            ) -> tuple[dict, bytes]:
        """Admit one request for ``tenant`` through the DRR and run it.

        Returns ``fn()``'s (header, blob) — or the in-band backpressure
        tuple when the tenant's queue is full / the grant timed out.
        ``fn`` exceptions propagate after the slot is released (the
        sidecar's ``respond`` reports them in-band, same as unfarmed).
        """
        tenant = str(tenant)
        ticket = _Ticket()
        _tls.grant_wait_s = 0.0
        t_enq = self._clock()
        with self._lock:
            self._register_locked(tenant)
            if self.throttle_fault.get(tenant, 0) > 0:
                self.throttle_fault[tenant] -= 1
                return self._throttle_locked(
                    tenant, "injected farm partition (chaos)")
            q = self._queues[tenant]
            if len(q) >= self.max_queued:
                return self._throttle_locked(
                    tenant, f"{len(q)} requests already queued "
                            f"(max_queued={self.max_queued})")
            q.append(ticket)
            self._grant_next_locked()
        if not ticket.granted.wait(self.grant_timeout_s):
            with self._lock:
                if not ticket.granted.is_set():
                    # never granted: withdraw and throttle — the slot
                    # was starved past any sane client deadline
                    try:
                        self._queues[tenant].remove(ticket)
                    except ValueError:
                        pass
                    return self._throttle_locked(
                        tenant, "grant wait timed out")
                # granted in the race window: fall through and run
        wait_s = max(0.0, self._clock() - t_enq)
        _tls.grant_wait_s = wait_s
        metrics.solver_farm_grant_wait_seconds.observe(tenant,
                                                       value=wait_s)
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            dur_us = int(wait_s * 1e6)
            now_us = int(tracer.clock() * 1e6)
            tracer.add_span("farm_grant_wait", now_us - dur_us, dur_us,
                            source=f"farm:{tenant or 'solver'}",
                            tenant=tenant)
        metrics.solver_farm_requests_total.inc(tenant)
        t0 = self._clock()
        try:
            out = fn()
        finally:
            self._complete(tenant, max(0.0, self._clock() - t0))
        ctl = resilience.controller
        if ctl.active(resilience.FEDERATION, "backpressure"):
            ctl.report(resilience.FEDERATION, "backpressure", False,
                       reason=f"farm served tenant {tenant!r}; "
                              "backpressure relieved")
        return out

    def _throttle_locked(self, tenant: str, why: str
                         ) -> tuple[dict, bytes]:
        self.throttled[tenant] = self.throttled.get(tenant, 0) + 1
        metrics.solver_farm_throttled_total.inc(tenant)
        resilience.controller.report(
            resilience.FEDERATION, "backpressure", True,
            reason=f"farm backpressure for tenant {tenant!r}: {why}")
        return _backpressure(tenant, why)


def attach_farm(server, scheduler: Optional[FarmScheduler] = None,
                **farm_kwargs) -> FarmScheduler:
    """Wire a FarmScheduler onto a ``SolverServer`` (service.py checks
    ``server.farm`` per request). Returns the scheduler for test/bench
    introspection."""
    if scheduler is None:
        scheduler = FarmScheduler(**farm_kwargs)
    server.farm = scheduler
    return scheduler
