"""A federated fleet on one solver farm, for either package: the record
tests/test_torch_federation.py pins.

bench.py's federation phase 1 (bench.py:1674-1848) made deterministic:
four tenants x two control planes at weights 2:2:1:1 share one
``SolverServer`` with a ``FarmScheduler`` (2 ms quantum, 16 sessions,
members padded to 64); each member is warmed one after another (24
workloads, a drain, two churn cycles), then every member runs
``CYCLES`` more churn cycles, interleaved member by member (bench.py
runs them for 5 s in threads; the interleaving here is fixed so that
the record is the same on every machine). The record per member is a
digest of its ``plan_fingerprint``, and per tenant the farm's served
count; zero cross-tenant state is asserted on the way.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_farm_pins.py``,
it prints the JAX package's record (a few seconds).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

JAX = "kueue_oss_tpu"
PORT = "kueue_oss_tpu_torch"

#: bench.py's tenants and weights, two control planes each
WEIGHTS = {"cp-a": 2.0, "cp-b": 2.0, "cp-c": 1.0, "cp-d": 1.0}
PLANES = 2
QUANTUM_S = 0.002
MAX_SESSIONS = 16
PAD_TO = 64
WARM_WORKLOADS = 24
#: interleaved churn cycles per member after the warm-up
CYCLES = 3


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def seed_cluster(types, store, n_cqs: int = 4, quota: int = 8) -> None:
    """bench.py's federation cluster: 4 ClusterQueues of 8 cpu."""
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", preemption=types.PreemptionPolicy(),
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))


def fed_wl(types, i: int, cpu: int = 1):
    return types.Workload(
        name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
        creation_time=float(i),
        podsets=[types.PodSet(name="main", count=1,
                              requests={"cpu": cpu})])


def churn(types, member, cycles: int, uid0: int, t0: int) -> int:
    """bench.py's churn: finish two, submit two, drain; per cycle."""
    uid = uid0
    for cyc in range(t0, t0 + cycles):
        admitted = sorted(
            k for k, w in member.store.workloads.items()
            if w.is_quota_reserved and not w.is_finished)
        for k in admitted[:2]:
            member.scheduler.finish_workload(k, now=float(cyc))
        for _ in range(2):
            member.store.add_workload(fed_wl(types, uid))
            uid += 1
        member.drain(now=float(cyc))
    return uid


def member_names() -> list[str]:
    return [f"{t}/{j}" for t in WEIGHTS for j in range(PLANES)]


def offsets() -> dict[str, int]:
    return {n: 10000 * i for i, n in enumerate(member_names())}


def fingerprint_digest(fp) -> str:
    return hashlib.sha256(json.dumps(fp).encode()).hexdigest()


def build_server(root: str, path: str, device: str = "cpu"):
    service = _mod(root, "solver.service")
    if root == JAX:
        return service.SolverServer(path, max_sessions=MAX_SESSIONS,
                                    mesh_mode="off")
    return service.SolverServer(path, device=device,
                                max_sessions=MAX_SESSIONS)


def build_members(root: str, path, device: str = "cpu") -> dict:
    """The fleet's members (``path`` None: in-process twins)."""
    fleet = _mod(root, "federation.fleet")
    types = _mod(root, "api.types")
    kw = {} if root == JAX else {"device": device}
    out = {}
    for name in member_names():
        tenant = name.split("/")[0]
        m = fleet.build_member(
            tenant if path is not None else f"{name}-twin",
            socket_path=path, seed=lambda s: seed_cluster(types, s),
            pad_to=PAD_TO, **kw)
        if root == JAX:
            m.engine.mesh_mode = "off"
        m.engine.relax_enabled = False
        out[name] = m
    return out


def warm(root: str, members: dict) -> dict[str, int]:
    """Each member one after another: its workloads, a drain, two churn
    cycles. Returns the next uid per member."""
    types = _mod(root, "api.types")
    uids = {}
    for name, m in members.items():
        for i in range(WARM_WORKLOADS):
            m.store.add_workload(fed_wl(types, i + offsets()[name]))
        m.drain(now=0.0)
        uids[name] = churn(types, m, 2, offsets()[name] + 100, t0=1)
    return uids


def host_checksums(root: str, members: dict) -> dict[str, int]:
    delta = _mod(root, "solver.delta")
    out = {}
    for name, m in members.items():
        sess = next(iter(m.engine._delta_sessions.values()))
        kwargs, meta = sess._last
        out[name] = delta.state_checksum(kwargs, meta)
    return out


def cross_tenant_violations(root: str, server, members: dict) -> list:
    """Resident sessions whose checksum is not one of their own
    tenant's control planes', or is another tenant's."""
    delta = _mod(root, "solver.delta")
    host = host_checksums(root, members)
    with server._sessions_lock:
        side = {k: delta.state_checksum(s.kwargs, s.meta)
                for k, s in server.sessions.items()}
    bad = []
    for (tenant, sid), chk in side.items():
        own = {v for n, v in host.items() if n.split("/")[0] == tenant}
        other = {v for n, v in host.items() if n.split("/")[0] != tenant}
        if chk not in own or chk in other:
            bad.append((tenant, sid))
    if not side:
        bad.append("no resident session")
    return bad


def fleet_record(root: str, device: str = "cpu") -> dict:
    """The fleet through one farm, warmed and churned in a fixed
    interleaving; returns the record the tests pin."""
    farm_mod = _mod(root, "federation.farm")
    types = _mod(root, "api.types")
    path = os.path.join(tempfile.mkdtemp(), "farm.sock")
    server = build_server(root, path, device)
    farm = farm_mod.attach_farm(server, weights=dict(WEIGHTS),
                                quantum_s=QUANTUM_S)
    server.serve_in_background()
    try:
        members = build_members(root, path, device)
        uids = warm(root, members)
        for cyc in range(3, 3 + CYCLES):
            for name, m in members.items():
                uids[name] = churn(types, m, 1, uids[name], t0=cyc)
        bad = cross_tenant_violations(root, server, members)
        if bad:
            raise AssertionError(f"cross-tenant state: {bad}")
        return {
            "fingerprints": {
                n: fingerprint_digest(
                    _mod(root, "federation.fleet").plan_fingerprint(
                        m.store, m.queues))
                for n, m in members.items()},
            "admitted": {n: len(_mod(root, "federation.fleet")
                                .plan_fingerprint(m.store, m.queues)[0])
                         for n, m in members.items()},
            "served": dict(sorted(farm.served.items())),
            "throttled": dict(farm.throttled),
            "sessions": len(server.sessions)}
    finally:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    print(json.dumps(fleet_record(JAX), indent=1))
