"""The port's span tracer (``kueue_oss_tpu_torch/debugger/profiling.py``)
and the spans the scheduler, the engine, the sidecar and the farm give
it, against the JAX package on the CPU.

Tolerance 0 on span names, order, nesting and arguments (cycle ids,
heads, sources, tenants; not the wall times): the tracer's own ring,
tracks and Chrome-trace export on an injected clock; ``attach_to_
scheduler`` over a lean flood with finishes (``schedule`` spans with
``nominate`` inside, ``solver_drain`` spans with the drain's cycle);
and a drain through a sidecar behind a farm, whose ``sidecar_solve``
and ``farm_grant_wait`` spans come back on their own tracks under the
drain's cycle id. Every Chrome trace is valid JSON.
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import json
import os
import tempfile

import torch_obs_pins as O

from kueue_oss_tpu.debugger import profiling as jax_prof
from kueue_oss_tpu_torch.debugger import profiling as port_prof

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"


def _shape(tracer) -> list:
    """(name, track, args) of every span, in ring order, with tracks
    renamed by first appearance (host thread ids differ by process)."""
    tracks: dict = {}
    out = []
    for name, tid, _ts, _dur, args in tracer.spans():
        out.append((name, tracks.setdefault(tid, len(tracks)),
                    dict(args or {})))
    return out


def _nesting_ok(tracer, outer: str, inner: str) -> bool:
    spans = tracer.spans()
    outers = [(ts, ts + dur) for n, _, ts, dur, _ in spans if n == outer]
    return all(any(a <= ts and ts + dur <= b for a, b in outers)
               for n, _, ts, dur, _ in spans if n == inner)


def test_tracer_ring_tracks_and_chrome_trace_match_jax():
    def drive(prof):
        t = [1.0]

        def clock():
            t[0] += 0.001
            return t[0]

        tr = prof.Tracer(max_spans=5, clock=clock)
        with tr.span("outer", cycle=1):
            with tr.span("inner"):
                pass
        tr.add_span("remote", 10, 5, source="sidecar:a", cycle=1)
        tr.track("sidecar:a", tenant="a")
        tr.add_span("wait", 3, 2, source="farm:a")
        tr.add_span("x", 1, 1, tid=7)
        tr.add_span("y", 2, 2, tid=7)  # rotates the ring
        trace = json.loads(tr.chrome_trace())
        for ev in trace["traceEvents"]:
            if ev["ph"] == "X" and ev["tid"] > 1000:
                ev["tid"] = "host"
        out = (trace, tr.durations_ms("inner"))
        tr.enabled = False
        with tr.span("off"):
            pass
        tr.clear()
        return out + (tr.spans(),)

    assert drive(port_prof) == drive(jax_prof)


def test_scheduler_and_drain_spans_match_jax():
    import torch_scheduler_pins as P

    shapes = []
    for pkg, prof, package in ((J, jax_prof, P.jax_package()),
                               (T, port_prof, P.port_package("cpu"))):
        O.reset(pkg)
        tr = prof.Tracer()
        O.run_lean(package, tracer=tr, prof=prof)
        json.loads(tr.chrome_trace())
        assert _nesting_ok(tr, "schedule", "nominate")
        shapes.append(_shape(tr))
        O.reset(pkg)
    assert shapes[1] == shapes[0]
    names = [s[0] for s in shapes[1]]
    assert {"schedule", "nominate", "solver_drain"} <= set(names)
    drains = [s[2]["cycle"] for s in shapes[1] if s[0] == "solver_drain"]
    assert len(drains) >= 2


def _farmed_drains(port: bool):
    from kueue_oss_tpu.api import types as jax_types
    from kueue_oss_tpu.core.queue_manager import QueueManager as JQ
    from kueue_oss_tpu.core.store import Store as JS
    from kueue_oss_tpu.scheduler.scheduler import Scheduler as JSched
    from kueue_oss_tpu.solver import service as jax_service
    from kueue_oss_tpu.solver.engine import SolverEngine as JEngine
    from kueue_oss_tpu.federation import farm as jax_farm
    from kueue_oss_tpu_torch.api import types as port_types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PQ
    from kueue_oss_tpu_torch.core.store import Store as PS
    from kueue_oss_tpu_torch.federation import farm as port_farm
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler as PSched
    from kueue_oss_tpu_torch.solver import service as port_service
    from kueue_oss_tpu_torch.solver.engine import SolverEngine as PEngine

    types = port_types if port else jax_types
    service = port_service if port else jax_service
    farm_mod = port_farm if port else jax_farm
    prof = port_prof if port else jax_prof
    path = os.path.join(tempfile.mkdtemp(), "s.sock")
    srv = (service.SolverServer(path, device="cpu") if port
           else service.SolverServer(path, mesh_mode="off"))
    t = [0.0]

    def clock():
        t[0] += 0.004  # every grant waits one tick
        return t[0]

    farm = farm_mod.attach_farm(srv, farm_mod.FarmScheduler(clock=clock))
    srv.serve_in_background()
    try:
        store = O._lean_store(types, PS if port else JS)
        queues = (PQ if port else JQ)(store)
        sched = (PSched if port else JSched)(store, queues)
        client = service.SolverClient(path, tenant="team-a")
        eng = (PEngine(store, queues, device="cpu", scheduler=sched,
                       remote=client) if port
               else JEngine(store, queues, scheduler=sched, remote=client,
                            mesh_mode="off"))
        eng.relax_enabled = False
        tr = prof.Tracer()
        eng.tracer = tr
        farm.tracer = tr
        O._flood(types, store, 24)
        eng.drain(now=0.0)
        sched.cycle_count += 1
        O._flood(types, store, 8, start=100)
        eng.drain(now=1.0)
        trace = json.loads(tr.chrome_trace())
        return _shape(tr), trace, farm.served
    finally:
        srv.shutdown()
        srv.server_close()


def test_sidecar_and_farm_spans_match_jax():
    O.reset(J)
    O.reset(T)
    want, _, jserved = _farmed_drains(False)
    got, trace, pserved = _farmed_drains(True)
    O.reset(J)
    O.reset(T)
    assert got == want
    assert pserved == jserved == {"team-a": 2}
    by_name: dict = {}
    for name, _, args in got:
        by_name.setdefault(name, []).append(args.get("cycle"))
    assert by_name["solver_drain"] == [1, 2]
    assert by_name["sidecar_solve"] == [1, 2]
    # per grant the farm stamps its own span (no cycle: the farm does
    # not know it), and the response carries one under the drain's cycle
    assert by_name["farm_grant_wait"] == [None, 1, None, 2]
    meta = {ev["args"]["name"]: ev["args"]
            for ev in trace["traceEvents"] if ev["ph"] == "M"}
    assert meta["sidecar:team-a"]["tenant"] == "team-a"
    assert "farm:team-a" in meta
