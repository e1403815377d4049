"""Seeded fault injection of the port: the solver sidecar and node
readiness.

Copies from ``kueue_oss_tpu/chaos/__init__.py``:

- ``FaultInjector`` (:63-126) and ``ChaosSolverServer`` (:128-247): a
  seeded per-request fault decision and a sidecar whose handler acts it
  out around the real solve path, so tests and chip_smoke.py drive the
  client's deadline and retries, the engine's breaker and its plan
  guard deterministically. The faults:

    ok            serve the request normally
    crash_pre     close the connection before reading the request
    crash         read the request, then die without replying
    hang          hold the connection open and never reply (the
                  client's deadline is the only way out)
    truncate      declare a full frame but send only part of it
    oversize      declare a frame above the client's max-frame guard
    garble        a well-framed response whose npz payload is noise
    corrupt_plan  a decodable plan with out-of-range flavor options and
                  admitted null / padding rows (the engine's plan guard,
                  not the transport)
    slow          delay the correct response by ``slow_s``

- ``NodeFlapInjector`` (:384-421): node-readiness flaps against the
  store.

- ``ClusterLossInjector`` (:424-497): a federated fleet's member loss:
  a MultiKueue worker dropped, restored or flapped against the port's
  ``MultiKueueController``, and a tenant's sessions evicted from the
  shared farm's ``SolverServer`` (``drop_tenant``).

- ``MeshFaultInjector`` (:249-315): device loss and mesh shrink through
  the engine's ``solve_fault_hook`` and ``refresh_mesh``.

- ``CrashPointInjector`` (:317-371): kill -9 (or raise) at a named
  durability point of ``persist/hooks.py``, in process or, through
  ``env()``, in a ``persist/crashtest.py`` child.

- ``chaos/campaign.py`` (the lazy ``ChaosCampaign``, ``CampaignSpec``,
  ``CampaignResult``, ``PROFILES``, ``PROFILE_SUBSYSTEM`` and
  ``run_campaign`` below): composed-fault campaigns with a convergence
  oracle.
"""

from __future__ import annotations

import io
import json
import random
import socketserver
import struct
import time
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.solver.service import (
    FULL_NAMES,
    LEAN_NAMES,
    SolverServer,
    _recv,
    _send,
    deserialize_problem,
    respond,
)

OK = "ok"
CRASH_PRE = "crash_pre"
CRASH = "crash"
HANG = "hang"
TRUNCATE = "truncate"
OVERSIZE = "oversize"
GARBLE = "garble"
CORRUPT_PLAN = "corrupt_plan"
SLOW = "slow"

FAULTS = (OK, CRASH_PRE, CRASH, HANG, TRUNCATE, OVERSIZE, GARBLE,
          CORRUPT_PLAN, SLOW)

#: ceiling on how long a "hang" holds its connection open server-side
#: (the client's deadline fires long before; it bounds the thread if a
#: test dies mid-hang)
_HANG_CAP_S = 30.0


class FaultInjector:
    """Seeded per-request fault decisions.

    ``schedule`` is an explicit fault sequence consumed in order; after
    it, ``weights`` ({fault: weight}) are sampled with the seeded RNG;
    with neither every request is served. ``injected`` counts what was
    injected."""

    def __init__(self, schedule=(), seed: int = 0,
                 weights: Optional[dict] = None,
                 slow_s: float = 0.01) -> None:
        for f in list(schedule) + list(weights or {}):
            if f not in FAULTS:
                raise ValueError(f"unknown fault {f!r}; one of {FAULTS}")
        self.schedule = list(schedule)
        self._i = 0
        self._rng = random.Random(seed)
        self.weights = dict(weights or {})
        self.slow_s = slow_s
        self.injected: dict[str, int] = {}

    def next_fault(self) -> str:
        if self._i < len(self.schedule):
            fault = self.schedule[self._i]
            self._i += 1
        elif self.weights:
            fault = self._rng.choices(
                list(self.weights), weights=list(self.weights.values()))[0]
        else:
            fault = OK
        self.injected[fault] = self.injected.get(fault, 0) + 1
        return fault

    def faults_injected(self) -> int:
        """Requests that got anything other than normal service."""
        return sum(n for f, n in self.injected.items() if f != OK)


def _corrupt_plan_response(header: dict, blob: bytes,
                           server=None) -> tuple[dict, bytes]:
    """A decodable response whose plan breaks every invariant the plan
    guard checks. A SYNC or legacy request carries the problem inline;
    for a DELTA the workload-axis width comes from the server's resident
    session (no session: an in-band resync, itself a valid fault)."""
    if header.get("kind") == "delta":
        sess = (server.get_session(str(header.get("sid", "")))
                if server is not None else None)
        if sess is None or sess.kwargs is None:
            return {"ok": False, "resync": "session_missing"}, b""
        return _corrupt_plan_arrays(header, sess.kwargs["wl_cqid"].shape[0])
    problem = deserialize_problem(header["meta"], blob)
    return _corrupt_plan_arrays(header, problem.wl_cqid.shape[0])


def _corrupt_plan_arrays(header: dict, W1: int) -> tuple[dict, bytes]:
    admitted = np.ones(W1, dtype=bool)
    parked = np.zeros(W1, dtype=bool)
    admit_round = np.zeros(W1, dtype=np.int32)
    rounds = np.int32(1)
    if header["full"]:
        g = max(1, int(header.get("g_max", 1)))
        opt = np.full((W1, g), 1 << 20, dtype=np.int32)
        names = FULL_NAMES
        arrays = [admitted, opt, admit_round, parked, rounds,
                  np.zeros(1, np.int32), np.zeros(1, np.int32),
                  np.zeros(W1, np.int32)]
    else:
        opt = np.full((W1,), 1 << 20, dtype=np.int32)
        names = LEAN_NAMES
        arrays = [admitted, opt, admit_round, parked, rounds,
                  np.zeros(1, np.int32)]
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(names, arrays)))
    return {"ok": True, "names": names}, buf.getvalue()


class _ChaosHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # noqa: C901 - one branch per fault
        injector: FaultInjector = self.server.injector
        fault = injector.next_fault()
        if fault == CRASH_PRE:
            return
        try:
            header, blob = _recv(self.request, self.server.max_frame_bytes)
        except ConnectionError:
            return
        if fault == CRASH:
            return
        if fault == HANG:
            try:
                # never reply; the client's deadline closes the socket
                self.request.settimeout(_HANG_CAP_S)
                self.request.recv(1)
            except OSError:
                pass
            return
        if fault == OVERSIZE:
            h = json.dumps({"ok": True, "names": ["admitted"]}).encode()
            try:
                self.request.sendall(
                    struct.pack(">II", len(h), 0xFFFF_FFF0))
                self.request.sendall(h)
            except OSError:
                pass
            return
        if fault == TRUNCATE:
            h = json.dumps({"ok": True, "names": ["admitted"]}).encode()
            try:
                # declare 128 payload bytes, deliver 64, close
                self.request.sendall(struct.pack(">II", len(h), 128))
                self.request.sendall(h)
                self.request.sendall(b"\x00" * 64)
            except OSError:
                pass
            return
        if fault == GARBLE:
            junk = bytes(injector._rng.getrandbits(8) for _ in range(96))
            try:
                _send(self.request,
                      {"ok": True, "names": ["admitted", "opt"]}, junk)
            except OSError:
                pass
            return
        if fault == CORRUPT_PLAN:
            try:
                resp_h, resp_b = _corrupt_plan_response(
                    header, blob, self.server)
                _send(self.request, resp_h, resp_b)
            except OSError:
                pass
            return
        if fault == SLOW:
            time.sleep(injector.slow_s)
        # the healthy tail: the production respond path, sessions too
        respond(self.request, header, blob, self.server)


class ChaosSolverServer(SolverServer):
    """A SolverServer whose handler consults a FaultInjector per
    request: ``ChaosSolverServer(path, FaultInjector(schedule=["crash",
    "ok"]))``. Runs its healthy solves on ``device`` ("cuda" unless the
    caller asks for the CPU)."""

    def __init__(self, socket_path: str, injector: FaultInjector,
                 max_frame_bytes: Optional[int] = None,
                 device="cuda") -> None:
        super().__init__(socket_path, device=device,
                         max_frame_bytes=max_frame_bytes)
        self.injector = injector
        self.RequestHandlerClass = _ChaosHandler


class MeshFaultInjector:
    """Deterministic device loss through the engine's
    ``solve_fault_hook`` seam: the hook runs right before each local
    solve, tagged with the arm about to run, so raising there stands in
    for the device failing at dispatch. The engine's contract under
    test:

      mesh fault   -> the same drain re-runs on the single-device arm
                      (``solver_fallback_total{mesh_error}``);
      both arms    -> ``SolverUnavailable``, and the scheduler finishes
                      the round on host cycles (``device_error``): the
                      whole mesh -> single -> host chain, never silent;
      mesh shrink  -> ``refresh_mesh(max_devices=n)`` re-detects a
                      narrower mesh; the next drain re-pads, the session
                      rides the forced full sync, the plans stay equal.

    An engine without a mesh never consumes the mesh faults, and
    ``shrink`` / ``restore`` re-detect a width of 0 there.
    """

    def __init__(self, engine) -> None:
        self.engine = engine
        self._mesh_faults = 0
        self._all_faults = 0
        self.injected: dict[str, int] = {}
        engine.solve_fault_hook = self._hook

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _hook(self, arm: str) -> None:
        if self._all_faults > 0:
            if arm == "single":
                self._all_faults -= 1  # terminal arm = one drain
            self._count(f"{arm}_lost")
            raise RuntimeError(
                f"injected device loss ({arm} arm unavailable)")
        if arm == "mesh" and self._mesh_faults > 0:
            self._mesh_faults -= 1
            self._count("mesh_lost")
            raise RuntimeError("injected mesh device loss")

    def lose_mesh(self, times: int = 1) -> None:
        """The next ``times`` mesh-arm solves fail (ICI/device loss)."""
        self._mesh_faults += int(times)

    def lose_all(self, times: int = 1) -> None:
        """The next ``times`` drains fail on EVERY local arm — the
        whole accelerator is gone; only host cycles remain."""
        self._all_faults += int(times)

    def shrink(self, n_devices: int) -> int:
        """Shrink the engine's mesh to ``n_devices`` (a partial device
        loss); returns the re-detected width."""
        self._count(f"shrink_{n_devices}")
        return self.engine.refresh_mesh(max_devices=n_devices)

    def restore(self) -> int:
        """Heal: clear pending faults and re-detect the full mesh."""
        self._mesh_faults = 0
        self._all_faults = 0
        return self.engine.refresh_mesh()

    def faults_injected(self) -> int:
        return sum(self.injected.values())


class CrashPointInjector:
    """Kill -9 the control plane at a named durability point
    (docs/DURABILITY.md; docs/ROBUSTNESS.md fault taxonomy).

    Two usage modes:

    - **subprocess** (the restart fault): ``env()`` returns the
      environment that arms the point inside a child control plane —
      ``persist/crashtest.py`` consumes it, SIGKILLs itself at the
      point, and a second invocation with ``--phase recover`` proves
      recovery. This is the production-faithful mode: the process
      really dies, nothing flushes.
    - **in-process** (unit tests): ``arm(mode="raise")`` makes the
      point raise :class:`kueue_oss_tpu_torch.persist.hooks.CrashPoint`
      instead of killing, so a test can assert on the half-written
      state directly.

    Points: pre_fsync, torn_tail, post_fsync_pre_apply,
    mid_checkpoint, mid_drain (``persist.hooks.CRASH_POINTS``).
    """

    def __init__(self, point: str, after: int = 0,
                 mode: str = "kill") -> None:
        from kueue_oss_tpu_torch.persist import hooks

        if point not in hooks.CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}; "
                             f"one of {hooks.CRASH_POINTS}")
        self.point = point
        self.after = int(after)
        self.mode = mode

    def arm(self) -> "CrashPointInjector":
        from kueue_oss_tpu_torch.persist import hooks

        hooks.arm(self.point, after=self.after, mode=self.mode)
        return self

    def disarm(self) -> None:
        from kueue_oss_tpu_torch.persist import hooks

        hooks.disarm()

    def __enter__(self) -> "CrashPointInjector":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()

    def env(self) -> dict:
        """Environment arming this point in a child process."""
        return {"KUEUE_CRASH_POINT": self.point,
                "KUEUE_CRASH_AFTER": str(self.after),
                "KUEUE_CRASH_MODE": self.mode}


def __getattr__(name: str):
    # campaign composition layer (chaos/campaign.py) — lazy so that
    # importing the injectors never pulls the scheduler stack
    if name in ("ChaosCampaign", "CampaignSpec", "CampaignResult",
                "PROFILES", "PROFILE_SUBSYSTEM", "run_campaign"):
        from kueue_oss_tpu_torch.chaos import campaign

        return getattr(campaign, name)
    raise AttributeError(name)


class NodeFlapInjector:
    """Seeded node-readiness flapping against the store.

    ``flap_down`` marks nodes NotReady (given names, or a seeded sample
    of the sorted ready node names: ``random.Random(seed).sample``, the
    draw the JAX package makes); ``flap_up`` restores them. Pairing the
    two inside or outside the failure controller's grace period drives
    the flap-recovery path deterministically.
    """

    def __init__(self, store, seed: int = 0) -> None:
        self.store = store
        self._rng = random.Random(seed)
        self._down: list[str] = []

    def flap_down(self, count: int = 1,
                  names: Optional[list[str]] = None) -> list[str]:
        if names is None:
            pool = sorted(n for n, node in self.store.nodes.items()
                          if node.ready)
            names = self._rng.sample(pool, min(count, len(pool)))
        for n in names:
            node = self.store.nodes[n]
            node.ready = False
            self.store.upsert_node(node)
        self._down.extend(names)
        return list(names)

    def flap_up(self, names: Optional[list[str]] = None) -> list[str]:
        if names is None:
            names, self._down = self._down, []
        else:
            self._down = [n for n in self._down if n not in names]
        for n in names:
            node = self.store.nodes.get(n)
            if node is not None:
                node.ready = True
                self.store.upsert_node(node)
        return list(names)


__all__ = ["CORRUPT_PLAN", "CRASH", "CRASH_PRE", "ChaosSolverServer",
           "CrashPointInjector", "FAULTS", "FaultInjector", "GARBLE",
           "HANG", "MeshFaultInjector", "NodeFlapInjector", "OK",
           "OVERSIZE", "SLOW", "TRUNCATE"]


class ClusterLossInjector:
    """Federation member-loss faults.

    Drives the three ways a federated fleet loses a member, against a
    live ``MultiKueueController`` (and optionally the shared farm's
    ``SolverServer``):

    - **worker silent-drop**: the worker stops heartbeating
      (``active=False``, ``last_seen`` frozen) without any cleanup —
      the hub must re-dispatch its workloads only after
      ``worker_lost_timeout_s`` elapses (workload.go remote-lost);
    - **farm-tenant eviction**: the shared sidecar drops every
      resident session of one tenant (capacity reclaim / chaos); the
      tenant's next frame must heal through RESYNC with zero impact on
      its neighbors' sessions;
    - **hub-link flap**: a drop/restore pair inside the grace window,
      which must NOT trigger re-dispatch.

    Deterministic: no clocks read here — callers pass ``now`` exactly
    like the controller's reconcile loop, so the grace-window boundary
    is driven, not raced. ``injected`` counts by fault kind.
    """

    def __init__(self, controller, farm_server=None,
                 seed: int = 0) -> None:
        self.controller = controller
        self.farm_server = farm_server
        self._rng = random.Random(seed)
        self.injected: dict[str, int] = {}

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _cluster(self, name: Optional[str]):
        clusters = self.controller.clusters
        if name is None:
            pool = sorted(n for n, c in clusters.items() if c.active)
            if not pool:
                raise ValueError("no active worker to drop")
            name = pool[self._rng.randrange(len(pool))]
        return clusters[name]

    def drop_worker(self, name: Optional[str] = None) -> str:
        """Silent worker loss: stops heartbeating, state intact."""
        cluster = self._cluster(name)
        cluster.active = False
        self._count("worker_drop")
        return cluster.name

    def restore_worker(self, name: str, now: float) -> str:
        """The worker reconnects; its next reconcile marks it seen."""
        cluster = self.controller.clusters[name]
        cluster.active = True
        cluster.mark_seen(now)
        self._count("worker_restore")
        return name

    def flap_worker(self, name: str, now: float) -> str:
        """Drop + immediate restore (a link flap INSIDE the grace
        window when the caller reconciles before the timeout)."""
        self.drop_worker(name)
        self._count("worker_flap")
        return self.restore_worker(name, now)

    def evict_farm_tenant(self, tenant: str) -> int:
        """Drop every resident farm session of one tenant; returns the
        eviction count (the server counts them under
        ``session_evictions["tenant_evicted"]``)."""
        if self.farm_server is None:
            raise ValueError("no farm server wired to this injector")
        self._count("tenant_evict")
        return self.farm_server.drop_tenant(tenant)

    def faults_injected(self) -> int:
        return sum(self.injected.values())
