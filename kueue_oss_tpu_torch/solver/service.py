"""Process-separated solver service: the sidecar and its client.

A port of ``kueue_oss_tpu/solver/service.py``. The control plane
exports, verifies and commits; only the solve crosses a unix socket to
a sidecar process that holds the padded problem resident on its device
(docs/SOLVER_PROTOCOL.md has the wire spec). The frames are the JAX
package's, byte for byte in layout: a length-prefixed JSON header and
an npz payload with the same field names and dtypes, so a JAX client
can use this server and this client a JAX server.

  legacy request: header {kind?: "solve", full, g_max, h_max, p_max,
    fs_enabled, meta} + npz(problem arrays); response {ok, names,
    spans} + npz(the full plan arrays)
  SYNC:  header {kind: "sync", sid, epoch, checksum, meta, ...} +
    npz(problem arrays): (re)opens session ``sid`` with the padded
    problem resident on the sidecar's device
  DELTA: header {kind: "delta", sid, epoch, base_epoch, checksum,
    meta_delta, ...} + compressed npz(dirty rows, replacements)
  session responses are compact: {ok, compact, epoch, mesh_devices,
    spans} + npz(the decided rows only); a session, epoch or checksum
    mismatch answers {ok: false, resync: <reason>} in-band and the
    client re-sends the problem as a SYNC within the same call.

A DELTA is applied to the session's numpy mirror first and checked
against the frame's ``state_checksum``; only then does it reach the
device (``DeviceResidentProblem.update``, which also refuses rows
outside its buffers), so a garbled frame fails on the host and is
answered in-band instead of tripping a device-side assert that would
end the sidecar's CUDA context for every session.

Resilience: a truncated frame, EOF mid-frame, an undecodable header or
payload, or a frame above ``max_frame_bytes`` (checked before
allocating) raises ``SolverProtocolError``; ``SolverClient.solve`` runs
under one deadline with bounded retries (exponential backoff with
seeded jitter, a fresh connection per attempt) and collapses exhaustion
into ``SolverUnavailable``; the server answers solve-side exceptions
in-band, so one bad request cannot wedge a handler thread.

Threads: every connection gets a handler thread. One process-wide
device lock (``_DEVICE_LOCK``) serialises every resident update and
solve, so two sessions never drain on the device at once and the
module-level launch counters of the kernel wrappers are only ever
touched by one thread; plans do not depend on it.

Farm: with a ``federation.FarmScheduler`` on ``server.farm``
(``federation.attach_farm``) every decoded request, SYNC and DELTA
frames included, runs its whole body under the farm's weighted deficit
round robin over solver wall-time: the frame header's tenant picks the
queue, the response carries the grant wait (``grant_wait_ms`` and a
``farm_grant_wait`` span), and an over-quota tenant gets an in-band
backpressure error, which the client raises as ``SolverUnavailable``
with no retry (the engine's breaker then degrades it to host cycles).
The farm grants one body at a time; a body takes ``_DEVICE_LOCK``
inside its grant, and the farm charges the body's wall, lock wait
included.

The framing and ``SolverClient`` import no torch: a control plane
without a GPU (or without torch) can use them. ``SolverServer`` runs on
``device`` ("cuda" unless the caller asks for the CPU; it raises without
CUDA). ``python -m kueue_oss_tpu_torch.solver.service SOCKET`` runs one
as a process.

Cut from the copy, each with its ROADMAP item:

- the multihost sidecar (``serve_multihost``, ``follower_solve_loop``,
  ``_bcast_bytes``) and the mesh solve (``_solve_resilient``'s mesh
  arm; ``mesh_devices`` is answered 0, as a JAX sidecar without a mesh
  answers): Queue A item 9;
- ``persist_hooks.crash_if("sidecar_session_store")``: the port has no
  persistence layer;
- ``metrics`` counters (kept as plain counters on the server and the
  client), the degradation ladder's farm rungs and devtel's
  ``note_wire``: the observability layer, Queue A item 13.
"""

from __future__ import annotations

import io
import json
import os
import random
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.solver.delta import (
    ARRAY_FIELDS,
    META_FIELDS,
    DeviceResidentProblem,
    SessionFrame,
    apply_delta,
    deserialize_delta,
    serialize_delta,
    state_checksum,
)
from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable
from kueue_oss_tpu_torch.solver.tensors import SolverProblem

#: names of the full plan's arrays on the wire, lean and FULL
LEAN_NAMES = ["admitted", "opt", "admit_round", "parked", "rounds", "usage"]
FULL_NAMES = LEAN_NAMES + ["wl_usage", "victim_reason"]

#: serialises every resident update and solve of this process
_DEVICE_LOCK = threading.Lock()


class SolverProtocolError(ConnectionError):
    """Garbled wire state: short read or EOF mid-frame, an oversized
    frame, or an undecodable header or payload. Distinct from a plain
    ConnectionError so callers can tell a misbehaving peer from an
    absent one."""


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def default_timeout_s() -> float:
    """Per-call deadline; KUEUE_SOLVER_TIMEOUT_S overrides 600 s."""
    return _env_float("KUEUE_SOLVER_TIMEOUT_S", 600.0)


def default_max_frame_bytes() -> int:
    """Frame-size guard; KUEUE_SOLVER_MAX_FRAME_MB overrides 256 MiB.
    Checked before allocating, on both sides of the wire."""
    return int(_env_float("KUEUE_SOLVER_MAX_FRAME_MB", 256.0) * (1 << 20))


def default_max_sessions() -> int:
    """Resident-session cap; KUEUE_SOLVER_MAX_SESSIONS overrides 4.
    Evictions are counted, never silent."""
    return max(1, int(_env_float("KUEUE_SOLVER_MAX_SESSIONS", 4.0)))


def _send(sock: socket.socket, header: dict, blob: bytes) -> None:
    h = json.dumps(header).encode()
    sock.sendall(struct.pack(">II", len(h), len(blob)))
    sock.sendall(h)
    sock.sendall(blob)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None,
                clock=time.monotonic) -> bytes:
    """Read exactly n bytes; with ``deadline`` (absolute, in ``clock``
    units) the whole read is bounded, not each recv: a peer dripping one
    byte per op-timeout must not reset the clock on every chunk."""
    buf = b""
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - clock()
            if remaining <= 0:
                raise TimeoutError(
                    f"deadline exhausted mid-frame: got {len(buf)} of "
                    f"{n} bytes")
            sock.settimeout(remaining)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise SolverProtocolError(
                f"peer closed mid-frame: got {len(buf)} of {n} bytes")
        buf += chunk
    return buf


def _recv(sock: socket.socket,
          max_frame_bytes: Optional[int] = None,
          deadline: Optional[float] = None,
          clock=time.monotonic) -> tuple[dict, bytes]:
    if max_frame_bytes is None:
        max_frame_bytes = default_max_frame_bytes()
    hlen, blen = struct.unpack(
        ">II", _recv_exact(sock, 8, deadline, clock))
    if hlen + blen > max_frame_bytes:
        # reject before allocating: the length prefix is peer-controlled
        raise SolverProtocolError(
            f"frame of {hlen + blen} bytes exceeds the "
            f"{max_frame_bytes}-byte limit")
    try:
        header = json.loads(_recv_exact(sock, hlen, deadline, clock))
    except (ValueError, UnicodeDecodeError) as e:
        raise SolverProtocolError(f"undecodable frame header: {e}") from e
    if not isinstance(header, dict):
        raise SolverProtocolError("frame header is not a JSON object")
    return header, _recv_exact(sock, blen, deadline, clock)


def serialize_problem(p: SolverProblem) -> tuple[dict, bytes]:
    arrays = {}
    for name in ARRAY_FIELDS:
        v = getattr(p, name)
        if v is not None:
            arrays[name] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    meta = {name: getattr(p, name) for name in META_FIELDS}
    return meta, buf.getvalue()


def deserialize_problem(meta: dict, blob: bytes) -> SolverProblem:
    data = np.load(io.BytesIO(blob))
    kwargs = {name: (data[name] if name in data else None)
              for name in ARRAY_FIELDS}
    kwargs.update(meta)
    return SolverProblem(**kwargs)


def _solve_kernel(tensors, header: dict, problem: SolverProblem):
    """Run the drain the request asks for on the resident tensors and
    read the plan back once; returns (numpy out tuple, array names).
    The caps are the header's (the control plane sized them)."""
    if header["full"]:
        from kueue_oss_tpu_torch.solver.full_kernels import (
            solve_backlog_full,
        )

        afs = (problem.cq_afs is not None
               and bool(np.asarray(problem.cq_afs).any()))
        out = solve_backlog_full(
            tensors, int(header["g_max"]), int(header["h_max"]),
            int(header["p_max"]), fs_enabled=bool(header["fs_enabled"]),
            afs=afs)
        names = FULL_NAMES
    else:
        from kueue_oss_tpu_torch.solver.kernels import solve_backlog

        out = solve_backlog(tensors)
        names = LEAN_NAMES
    return tuple(a.cpu().numpy() for a in out), names


def _spans(header: dict, t0: float, wait_s: float = 0.0) -> list[dict]:
    """The response's trace-context spans: the sidecar solve itself plus
    (farmed requests) ``wait_s``, the DRR grant wait the handler thread
    just paid. Every span names its ``source`` (a per-process or
    per-tenant track)."""
    tenant = str(header.get("tenant", ""))
    src_tail = tenant or "solver"
    span_args = {"full": bool(header["full"]),
                 "kind": header.get("kind", "solve"),
                 "source": f"sidecar:{src_tail}"}
    if tenant:
        span_args["tenant"] = tenant
    if header.get("trace_cycle") is not None:
        span_args["cycle"] = header["trace_cycle"]
    solve_dur_us = int((time.perf_counter() - t0) * 1e6)
    spans = [{"name": "sidecar_solve", "dur_us": solve_dur_us,
              "args": span_args}]
    if wait_s > 0.0:
        wait_args = {"kind": "grant_wait", "source": f"farm:{src_tail}"}
        if tenant:
            wait_args["tenant"] = tenant
        if header.get("trace_cycle") is not None:
            wait_args["cycle"] = header["trace_cycle"]
        # the wait ended when the solve began: end_skew_us places it
        # just before the solve span (both end at the response)
        spans.append({"name": "farm_grant_wait",
                      "dur_us": int(wait_s * 1e6),
                      "end_skew_us": solve_dur_us,
                      "args": wait_args})
    return spans


def compact_plan(out, full: bool) -> dict[str, np.ndarray]:
    """A plan as its decided rows only: admitted indices (with their
    flavor options and rounds), parked indices, and the nonzero
    victim-reason rows."""
    admitted = np.asarray(out[0]).astype(bool)
    opt = np.asarray(out[1])
    admit_round = np.asarray(out[2])
    parked = np.asarray(out[3]).astype(bool)
    adm_idx = np.nonzero(admitted)[0].astype(np.int32)
    arrays = {
        "adm_idx": adm_idx,
        "adm_opt": opt[adm_idx].astype(np.int32),
        "adm_round": admit_round[adm_idx].astype(np.int32),
        "park_idx": np.nonzero(parked)[0].astype(np.int32),
        "rounds": np.asarray(out[4]),
    }
    if full:
        vr = np.asarray(out[7])
        vr_idx = np.nonzero(vr)[0].astype(np.int32)
        arrays["vr_idx"] = vr_idx
        arrays["vr_val"] = vr[vr_idx].astype(np.int32)
    return arrays


def expand_compact_plan(data, W1: int, full: bool, g_max: int):
    """Client-side inverse of compact_plan: the dense arrays the
    engine's plan guard and apply paths read. A pure scatter: overlaps
    or out-of-range indices of a corrupt response survive into the dense
    arrays for the guard to reject."""
    adm_idx = np.asarray(data["adm_idx"])
    adm_opt = np.asarray(data["adm_opt"])
    admitted = np.zeros(W1, dtype=bool)
    parked = np.zeros(W1, dtype=bool)
    admitted[adm_idx] = True
    parked[np.asarray(data["park_idx"])] = True
    if full:
        g = adm_opt.shape[1] if adm_opt.ndim == 2 else max(1, g_max)
        opt = np.zeros((W1, g), dtype=np.int32)
        admit_round = np.full(W1, -1, dtype=np.int32)
    else:
        opt = np.zeros(W1, dtype=np.int32)
        admit_round = np.zeros(W1, dtype=np.int32)
    opt[adm_idx] = adm_opt
    admit_round[adm_idx] = np.asarray(data["adm_round"])
    rounds = np.asarray(data["rounds"])
    usage = np.zeros(1, dtype=np.int32)  # the engine ignores usage
    if not full:
        return admitted, opt, admit_round, parked, rounds, usage
    victim = np.zeros(W1, dtype=np.int32)
    victim[np.asarray(data["vr_idx"])] = np.asarray(data["vr_val"])
    return (admitted, opt, admit_round, parked, rounds, usage,
            np.zeros(1, dtype=np.int32), victim)


class _SidecarSession:
    """Resident state of one delta-sync session: the problem's numpy
    mirror and its tensors kept on the server's device across drains."""

    def __init__(self, device) -> None:
        self.lock = threading.Lock()
        self.kwargs: Optional[dict] = None
        self.meta: Optional[dict] = None
        self.epoch = -1
        self.device = DeviceResidentProblem(device)


def _resync(reason: str, server=None) -> tuple[dict, bytes]:
    if server is not None:
        server._count("resyncs", reason)
    return {"ok": False, "resync": reason}, b""


def _session_solve(sess: _SidecarSession, problem: SolverProblem,
                   frame: SessionFrame, header: dict):
    """Update the session's resident tensors by the frame and solve."""
    with _DEVICE_LOCK:
        tensors = sess.device.update(problem, frame, bool(header["full"]))
        return _solve_kernel(tensors, header, problem)[0]


def _session_request(header: dict, blob: bytes, server,
                     wait_s: float = 0.0) -> tuple[dict, bytes]:
    """Handle a SYNC or DELTA frame against the server's session store;
    ``wait_s`` is a farm's grant wait for the spans."""
    t0 = time.perf_counter()
    kind = header["kind"]
    sid = str(header.get("sid", ""))
    tenant = str(header.get("tenant", ""))
    if kind == "sync":
        data = np.load(io.BytesIO(blob))
        kwargs = {name: (np.array(data[name]) if name in data else None)
                  for name in ARRAY_FIELDS}
        meta = {k: int(v) for k, v in dict(header["meta"]).items()}
        want = header.get("checksum")
        if want is not None and state_checksum(kwargs, meta) != int(want):
            # a sync that decoded but does not match its own checksum is
            # transport corruption, not a session divergence
            return {"ok": False, "error": "sync frame checksum mismatch"
                    }, b""
        sess = server.session(sid, tenant)
        with sess.lock:
            sess.kwargs, sess.meta = kwargs, meta
            sess.epoch = int(header.get("epoch", 0))
            problem = SolverProblem(**kwargs, **meta)
            frame = SessionFrame(epoch=sess.epoch,
                                 checksum=int(want or 0), delta=None)
            out = _session_solve(sess, problem, frame, header)
            arrays = compact_plan(out, bool(header["full"]))
            epoch = sess.epoch
    else:  # delta
        sess = server.get_session(sid, tenant)
        if sess is None:
            return _resync("session_missing", server)
        with sess.lock:
            if sess.kwargs is None:
                return _resync("session_missing", server)
            if int(header["base_epoch"]) != sess.epoch:
                return _resync("epoch_mismatch", server)
            delta = deserialize_delta(header, blob)
            # the numpy mirror first: a garbled row fails here, on the
            # host, and is answered in-band
            apply_delta(sess.kwargs, sess.meta, delta)
            sess.epoch = delta.epoch
            if state_checksum(sess.kwargs, sess.meta) != delta.checksum:
                # resident state diverged from the host's: drop the
                # session so the client re-seeds it with a full SYNC
                server.drop_session(sid, tenant)
                return _resync("checksum_mismatch", server)
            problem = SolverProblem(**sess.kwargs, **sess.meta)
            frame = SessionFrame(epoch=delta.epoch,
                                 checksum=delta.checksum, delta=delta)
            out = _session_solve(sess, problem, frame, header)
            arrays = compact_plan(out, bool(header["full"]))
            epoch = sess.epoch
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    # a sidecar without a mesh advertises width 0 (meshutil.py: item 9)
    return {"ok": True, "compact": True, "epoch": epoch,
            "mesh_devices": 0,
            "spans": _spans(header, t0, wait_s)}, buf.getvalue()


def solve_request(header: dict, blob: bytes,
                  server=None) -> tuple[dict, bytes]:
    """Run one solve for a decoded request; returns (header, npz blob).

    Shared by the production handler and the chaos harness. ``server``
    holds the session store and the device; without one, a SYNC is
    refused in-band and a DELTA answers ``session_unsupported``. With a
    farm attached (``server.farm``) the whole body runs under its DRR
    admission, and a served response echoes the grant wait in
    ``grant_wait_ms``."""
    if server is not None:
        server._count("frames", header.get("kind", "solve"))
    farm = getattr(server, "farm", None)
    if farm is not None:
        from kueue_oss_tpu_torch.federation.farm import last_grant_wait_s

        # the lambda runs inside the grant, on this thread: it reads the
        # wait the farm just recorded
        resp, out = farm.run(
            str(header.get("tenant", "")),
            lambda: _solve_request_body(header, blob, server,
                                        last_grant_wait_s()))
        if resp.get("ok"):
            resp.setdefault("grant_wait_ms",
                            round(last_grant_wait_s() * 1e3, 3))
        return resp, out
    return _solve_request_body(header, blob, server)


def _solve_request_body(header: dict, blob: bytes, server=None,
                        wait_s: float = 0.0) -> tuple[dict, bytes]:
    kind = header.get("kind", "solve")
    if kind in ("sync", "delta"):
        if server is None:
            if kind == "delta":
                return _resync("session_unsupported")
            return {"ok": False, "error": "session frames need a "
                    "SolverServer"}, b""
        return _session_request(header, blob, server, wait_s)
    t0 = time.perf_counter()
    if server is None:
        raise ValueError("solve_request needs a SolverServer for its "
                         "device")
    problem = deserialize_problem(header["meta"], blob)
    with _DEVICE_LOCK:
        if header["full"]:
            from kueue_oss_tpu_torch.solver.full_kernels import (
                to_device_full,
            )

            tensors = to_device_full(problem, server.device)
        else:
            from kueue_oss_tpu_torch.solver.kernels import to_device

            tensors = to_device(problem, server.device)
        out, names = _solve_kernel(tensors, header, problem)
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(names, out)))
    return {"ok": True, "names": names,
            "spans": _spans(header, t0, wait_s)}, buf.getvalue()


def respond(sock: socket.socket, header: dict, blob: bytes,
            server=None) -> None:
    """Solve a decoded request and reply on ``sock``; solve-side
    exceptions are answered in-band, a vanished client is ignored.
    Shared by the production handler and the chaos harness's healthy
    tail."""
    try:
        resp_header, resp_blob = solve_request(header, blob, server)
    except Exception as e:  # answer in-band; do not wedge the thread
        resp_header, resp_blob = {"ok": False, "error": repr(e)}, b""
    try:
        _send(sock, resp_header, resp_blob)
    except OSError:
        return  # the client gave up (deadline) mid-response


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        try:
            # a client that stalls mid-frame must not pin this handler
            # thread forever: the read shares one deadline
            header, blob = _recv(
                self.request, self.server.max_frame_bytes,
                deadline=time.monotonic() + self.server.read_timeout_s)
        except (ConnectionError, TimeoutError):
            return  # covers SolverProtocolError: drop the bad request
        respond(self.request, header, blob, self.server)


class SolverServer(socketserver.ThreadingUnixStreamServer):
    """The sidecar body: ``SolverServer(path).serve_forever()``.

    Sessions are keyed by (tenant, sid) and capped LRU at
    ``max_sessions``; ``frames`` counts requests by kind, ``resyncs``
    the in-band resync answers by reason and ``session_evictions`` the
    dropped sessions by cause ("lru", "tenant_evicted"). ``farm`` (None,
    or a ``federation.FarmScheduler``) admits every request through its
    per-tenant DRR queue."""

    allow_reuse_address = True
    # a wedged client connection must not hang server_close()
    daemon_threads = True

    def __init__(self, socket_path: str, device="cuda",
                 max_frame_bytes: Optional[int] = None,
                 read_timeout_s: Optional[float] = None,
                 max_sessions: Optional[int] = None) -> None:
        from kueue_oss_tpu_torch.device import resolve_device

        self.device = resolve_device(device)  # raises without CUDA
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        super().__init__(socket_path, _Handler)
        self.socket_path = socket_path
        self.max_frame_bytes = (max_frame_bytes if max_frame_bytes
                                is not None else default_max_frame_bytes())
        self.read_timeout_s = (read_timeout_s if read_timeout_s
                               is not None else default_timeout_s())
        self.sessions: dict[tuple[str, str], _SidecarSession] = {}
        self._sessions_lock = threading.Lock()
        self.max_sessions = (max(1, int(max_sessions))
                             if max_sessions is not None
                             else default_max_sessions())
        self.frames: dict[str, int] = {}
        self.resyncs: dict[str, int] = {}
        self.session_evictions: dict[str, int] = {}
        self._counts_lock = threading.Lock()
        #: optional federation FarmScheduler (federation.attach_farm)
        self.farm = None

    def _count(self, what: str, key: str, by: int = 1) -> None:
        with self._counts_lock:
            table = getattr(self, what)
            table[key] = table.get(key, 0) + by

    def session(self, sid: str, tenant: str = "") -> _SidecarSession:
        key = (tenant, sid)
        with self._sessions_lock:
            sess = self.sessions.pop(key, None)
            if sess is None:
                sess = _SidecarSession(self.device)
            self.sessions[key] = sess  # re-insert = LRU touch
            while len(self.sessions) > self.max_sessions:
                self.sessions.pop(next(iter(self.sessions)))
                self._count("session_evictions", "lru")
            return sess

    def get_session(self, sid: str,
                    tenant: str = "") -> Optional[_SidecarSession]:
        key = (tenant, sid)
        with self._sessions_lock:
            sess = self.sessions.pop(key, None)
            if sess is not None:
                self.sessions[key] = sess
            return sess

    def drop_session(self, sid: str, tenant: str = "") -> None:
        with self._sessions_lock:
            self.sessions.pop((tenant, sid), None)

    def drop_tenant(self, tenant: str) -> int:
        """Evict every resident session of one tenant; its next frame
        answers ``resync: session_missing`` and its client re-seeds with
        a SYNC. Returns the eviction count."""
        with self._sessions_lock:
            victims = [k for k in self.sessions if k[0] == tenant]
            for k in victims:
                self.sessions.pop(k, None)
            if victims:
                self._count("session_evictions", "tenant_evicted",
                            len(victims))
            return len(victims)

    def serve_in_background(self) -> threading.Thread:
        # a short poll keeps shutdown() prompt
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             kwargs={"poll_interval": 0.05})
        t.start()
        return t


class _ClientSession:
    """Client-side view of one sidecar session (per engine kernel kind)."""

    __slots__ = ("sid", "acked_epoch")

    def __init__(self) -> None:
        self.sid = os.urandom(8).hex()
        self.acked_epoch = -1


class _ResyncRequested(Exception):
    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class SolverClient:
    """Engine-side stub: ``SolverEngine(remote=SolverClient(path))``.

    Every ``solve`` runs under a per-call deadline (``timeout_s``) with
    up to ``max_retries`` re-attempts on transport faults, each on a
    fresh connection (a restarted sidecar is reached again) after an
    exponential backoff with seeded jitter. Exhaustion raises
    ``SolverUnavailable`` for the engine's breaker.

    With a ``frame`` (the engine's session frame) the request goes out
    as a DELTA when the sidecar is known to hold the frame's base epoch,
    else as a SYNC; an in-band resync answer falls back to a SYNC within
    the same call (once: a second demand is a backend fault).

    Wire accounting: ``bytes_by_kind`` and ``frames_by_kind`` by frame
    kind ("legacy", "sync", "delta", "resync"), ``last_frame`` (kind,
    bytes), ``last_grant_wait_ms`` (a farm's grant wait echoed by the
    last successful response; 0 from a dedicated sidecar); plain
    counters for the JAX metrics: ``attempts``
    (connections tried), ``retries``, ``failures`` by kind ("timeout",
    "protocol", "connection", "server"), ``resyncs`` by reason and
    ``deadline_exceeded``. ``clock`` / ``sleep`` are injectable.
    """

    #: engines check this before routing session frames here
    supports_sessions = True

    def __init__(self, socket_path: str,
                 timeout_s: Optional[float] = None,
                 max_retries: int = 2,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 max_frame_bytes: Optional[int] = None,
                 jitter_seed: int = 0,
                 clock=time.monotonic,
                 sleep=time.sleep,
                 sessions: Optional[bool] = None,
                 tenant: str = "") -> None:
        self.socket_path = socket_path
        #: tenant id on every frame header; the sidecar keys sessions
        #: under (tenant, sid)
        self.tenant = str(tenant)
        self.timeout_s = (timeout_s if timeout_s is not None
                          else default_timeout_s())
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.max_frame_bytes = (max_frame_bytes if max_frame_bytes
                                is not None else default_max_frame_bytes())
        self._rng = random.Random(jitter_seed)
        self._clock = clock
        self._sleep = sleep
        #: host cycle id shipped in the next request's header
        self.trace_cycle: Optional[int] = None
        #: sidecar spans from the last successful response
        self.last_spans: list[dict] = []
        #: the farm's DRR grant wait echoed by the last successful
        #: response (ms; 0 = dedicated sidecar or idle farm)
        self.last_grant_wait_ms = 0.0
        #: the sidecar's advertised mesh width (0 = none)
        self.remote_mesh_devices = 0
        if sessions is None:
            sessions = os.environ.get("KUEUE_SOLVER_SESSIONS") != "0"
        self.use_sessions = bool(sessions)
        self._sessions: dict[str, _ClientSession] = {}
        self.bytes_by_kind: dict[str, int] = {}
        self.frames_by_kind: dict[str, int] = {}
        self.last_frame: Optional[tuple[str, int]] = None
        self.attempts = 0
        self.retries = 0
        self.failures: dict[str, int] = {}
        self.resyncs: dict[str, int] = {}
        self.deadline_exceeded = 0

    @classmethod
    def from_config(cls, cfg) -> "SolverClient":
        """Build from a config.SolverBackendConfig."""
        if cfg.socket_path is None:
            raise ValueError("solver.socketPath is required for a remote "
                             "solver backend")
        return cls(cfg.socket_path,
                   timeout_s=cfg.timeout_seconds,
                   max_retries=cfg.max_retries,
                   backoff_base_s=cfg.retry_backoff_base_seconds,
                   backoff_max_s=cfg.retry_backoff_max_seconds,
                   max_frame_bytes=cfg.max_frame_bytes,
                   sessions=getattr(cfg, "sessions_enabled", None),
                   tenant=getattr(cfg, "tenant", "")
                   or os.environ.get("KUEUE_SOLVER_TENANT", ""))

    def _fail(self, kind: str) -> None:
        self.failures[kind] = self.failures.get(kind, 0) + 1

    # -- request payloads --------------------------------------------------

    def _base_params(self, full: bool, g_max: int, h_max: int,
                     p_max: int, fs_enabled: bool) -> dict:
        params = {"full": full, "g_max": g_max, "h_max": h_max,
                  "p_max": p_max, "fs_enabled": fs_enabled}
        if self.tenant:
            params["tenant"] = self.tenant
        if self.trace_cycle is not None:
            params["trace_cycle"] = int(self.trace_cycle)
        return params

    def _build_payload(self, mode: str, problem: SolverProblem,
                       params: dict, frame, st) -> tuple[dict, bytes]:
        if mode == "legacy":
            meta, blob = serialize_problem(problem)
            header = {**params, "meta": meta}
        elif mode == "delta":
            dh, blob = serialize_delta(frame.delta)
            header = {**params, **dh, "kind": "delta", "sid": st.sid}
        else:  # sync / resync
            meta, blob = serialize_problem(problem)
            header = {**params, "meta": meta, "kind": "sync",
                      "sid": st.sid, "epoch": frame.epoch,
                      "checksum": frame.checksum}
        # the frame guard holds for our own request too: a server-side
        # rejection shows up as a reset and would be retried every drain
        n_frame = len(json.dumps(header).encode()) + len(blob)
        if n_frame > self.max_frame_bytes:
            raise SolverUnavailable(
                f"request frame of {n_frame} bytes exceeds the "
                f"{self.max_frame_bytes}-byte limit (problem too large "
                "for the remote backend)")
        return header, blob

    def _account(self, kind: str, header: dict, blob: bytes) -> None:
        n = len(json.dumps(header).encode()) + len(blob)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n
        self.frames_by_kind[kind] = self.frames_by_kind.get(kind, 0) + 1
        self.last_frame = (kind, n)

    # -- the call ----------------------------------------------------------

    def solve(self, problem: SolverProblem, *, full: bool,
              g_max: int = 1, h_max: int = 32, p_max: int = 128,
              fs_enabled: bool = False, frame=None,
              session_key: str = "default"):
        params = self._base_params(full, g_max, h_max, p_max, fs_enabled)
        self.last_spans = []
        st = None
        mode = "legacy"
        if frame is not None and self.use_sessions:
            st = self._sessions.setdefault(session_key, _ClientSession())
            mode = ("delta" if (frame.delta is not None
                                and st.acked_epoch
                                == frame.delta.base_epoch)
                    else "sync")
        header, blob = self._build_payload(mode, problem, params,
                                           frame, st)
        deadline = self._clock() + self.timeout_s
        attempt = 0
        resynced = False
        last_err: Optional[BaseException] = None
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                self.deadline_exceeded += 1
                raise SolverUnavailable(
                    f"solver call deadline ({self.timeout_s}s) exhausted "
                    f"after {attempt} attempt(s): {last_err!r}"
                ) from last_err
            try:
                out = self._solve_once(header, blob, remaining,
                                       problem, params)
                if st is not None:
                    st.acked_epoch = frame.epoch
                self._account("resync" if resynced else mode,
                              header, blob)
                return out
            except _ResyncRequested as e:
                # the sidecar lost (or never had) our session: fall back
                # to a SYNC within this call, outside the retry budget
                # (the sidecar is demonstrably alive)
                self.resyncs[e.reason] = self.resyncs.get(e.reason, 0) + 1
                if mode != "delta" or resynced:
                    raise SolverUnavailable(
                        f"sidecar demanded resync twice: {e.reason}")
                resynced = True
                mode = "sync"
                header, blob = self._build_payload(
                    "sync", problem, params, frame, st)
                continue
            except (TimeoutError, socket.timeout) as e:
                last_err = e
                self._fail("timeout")
            except SolverProtocolError as e:
                last_err = e
                self._fail("protocol")
            except OSError as e:  # refused / reset / missing socket
                last_err = e
                self._fail("connection")
            attempt += 1
            if attempt > self.max_retries:
                raise SolverUnavailable(
                    f"solver call failed after {attempt} attempt(s): "
                    f"{last_err!r}") from last_err
            self.retries += 1
            delay = min(self.backoff_base_s * (2 ** (attempt - 1)),
                        self.backoff_max_s)
            delay += self._rng.uniform(0, delay)  # full jitter
            delay = min(delay, max(0.0, deadline - self._clock()))
            if delay > 0:
                self._sleep(delay)

    def _solve_once(self, header: dict, blob: bytes, budget_s: float,
                    problem: SolverProblem, params: dict):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(budget_s)  # bounds connect and the send as ops
        op_deadline = self._clock() + budget_s
        self.attempts += 1
        try:
            sock.connect(self.socket_path)
            _send(sock, header, blob)
            # the whole response read shares one deadline
            resp, body = _recv(sock, self.max_frame_bytes,
                               deadline=op_deadline, clock=self._clock)
        finally:
            sock.close()
        if not resp.get("ok", False):
            if isinstance(resp.get("resync"), str):
                raise _ResyncRequested(resp["resync"])
            # the sidecar is up but the solve failed (a farm's
            # backpressure among them: the engine's breaker degrades the
            # control plane to host cycles); a retry would fail again,
            # so do not burn the deadline on it
            self._fail("server")
            raise SolverUnavailable(
                f"solver sidecar reported failure: "
                f"{resp.get('error', 'unknown')}")
        spans = resp.get("spans")
        self.last_spans = spans if isinstance(spans, list) else []
        try:
            self.last_grant_wait_ms = float(
                resp.get("grant_wait_ms", 0.0) or 0.0)
        except (TypeError, ValueError):
            self.last_grant_wait_ms = 0.0
        try:
            self.remote_mesh_devices = int(resp.get("mesh_devices", 0))
        except (TypeError, ValueError):
            self.remote_mesh_devices = 0
        try:
            data = np.load(io.BytesIO(body))
            if resp.get("compact"):
                return expand_compact_plan(
                    data, problem.wl_cqid.shape[0],
                    bool(params["full"]), int(params["g_max"]))
            names = resp.get("names")
            if not isinstance(names, list) or not names:
                raise SolverProtocolError(
                    "response header carries no names")
            return tuple(data[n] for n in names)
        except SolverProtocolError:
            raise
        except Exception as e:  # zipfile / npz decode errors
            raise SolverProtocolError(
                f"undecodable plan payload: {e!r}") from e


def wait_for_server(path: str, timeout_s: float = 120.0,
                    alive=lambda: True) -> float:
    """Block until a server accepts connections on ``path`` (a stale
    socket file of a killed sidecar refuses them); returns the seconds
    waited. ``alive`` reports whether the process being waited on still
    runs, so a sidecar that died at start fails fast."""
    t0 = time.monotonic()
    while True:
        if not alive():
            raise RuntimeError(f"the sidecar for {path} exited at start")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(path)
            return time.monotonic() - t0
        except OSError:
            if time.monotonic() - t0 > timeout_s:
                raise
            time.sleep(0.05)
        finally:
            sock.close()


def main(argv=None) -> int:
    """``python -m kueue_oss_tpu_torch.solver.service SOCKET [--device
    cuda|cpu]``: serve until SIGTERM or SIGINT (the session cap comes
    from ``KUEUE_SOLVER_MAX_SESSIONS``), then print one JSON line of what was served (frames by kind, resyncs,
    session evictions, resident sessions, and this process's launches of
    the hand kernels)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("socket")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from kueue_oss_tpu_torch.device import resolve_device

    # touch the device before binding: the socket appears once the
    # first solve no longer pays for the context
    torch.zeros(1, device=resolve_device(args.device))
    server = SolverServer(args.socket, device=args.device)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.serve_in_background()
    stop.wait()
    server.shutdown()
    server.server_close()
    from kueue_oss_tpu_torch.solver import cuda_relax, cuda_tas

    print(json.dumps({
        "frames": server.frames, "resyncs": server.resyncs,
        "session_evictions": server.session_evictions,
        "sessions": len(server.sessions),
        "launches": {
            "leaf_states": cuda_tas.leaf_states.launches,
            "tas_place_sequential": cuda_tas.tas_place_sequential.launches,
            "fill_counts": cuda_tas.launch_counts["fill_counts"],
            "relax_lp": cuda_relax.relax_lp.launches}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
