"""The port's host TAS placement against the JAX one, tolerance 0.

``TASFlavorSnapshot.find_topology_assignments`` of both packages runs on
identical trees and requests: the scenario shapes of ``tests/test_tas.py``
(required / preferred / unconstrained levels, best fit, usage and
simulate-empty, taints and selectors, slices, leader groups, node
replacement), balanced placement and multi-layer slices with their
gates on, and seeded random trees. Every case runs with the host
roll-up (``host_fill``) and with the fill-in counts on the device path
(``device_fill``: TASDeviceFillCounts on in both packages; the port's
snapshot runs ``_device_fill`` on CPU tensors, the JAX one on the CPU
backend), and must give the same assignments, failure messages and, for
``_fill_in_counts`` itself, the same five states on every domain. One
case runs the JAX side's Pallas leaf kernel in interpret mode
(``KUEUE_TPU_PALLAS=1``).
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.tas import snapshot as jax_snap
from kueue_oss_tpu_torch import features as port_features
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.tas import snapshot as port_snap

HOST = "kubernetes.io/hostname"
BLOCK = "cloud/block"
RACK = "cloud/rack"


class Pkg:
    """One package's types, snapshot module and build options."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.t = jax_types if name == "jax" else port_types
        self.snap = jax_snap if name == "jax" else port_snap
        self.build_kw = {} if name == "jax" else {"device": "cpu"}

    def build(self, nodes, levels=(BLOCK, RACK, HOST), **kw):
        return self.snap.build_tas_flavor_snapshot(
            "default", list(levels), nodes, **kw, **self.build_kw)

    def nodes(self, blocks=1, racks=2, hosts=2, cpu=4000, taints=(),
              labels=None):
        out = []
        for b in range(blocks):
            for r in range(racks):
                for h in range(hosts):
                    lab = {BLOCK: f"b{b}", RACK: f"b{b}-r{r}"}
                    lab.update(labels or {})
                    out.append(self.t.Node(
                        name=f"n-{b}-{r}-{h}", labels=lab,
                        allocatable={"cpu": cpu},
                        taints=[self.t.Taint(**tt) for tt in taints]))
        return out

    def podset(self, name="main", count=1, cpu=1000, tolerations=(),
               node_selector=None, **tr):
        return self.t.PodSet(
            name=name, count=count, requests={"cpu": cpu},
            node_selector=dict(node_selector or {}),
            tolerations=[self.t.Toleration(**x) for x in tolerations],
            topology_request=self.t.PodSetTopologyRequest(**tr))

    def req(self, ps, count=None, group=None):
        return self.snap.TASPodSetRequest(
            podset=ps, single_pod_requests=dict(ps.requests),
            count=ps.count if count is None else count, flavor="default",
            podset_group_name=group)


@pytest.fixture(params=["host_fill", "device_fill"])
def fill_mode(request):
    gates = {"TASDeviceFillCounts": request.param == "device_fill"}
    jax_features.set_gates(gates)
    port_features.set_gates(gates)
    yield request.param
    jax_features.reset()
    port_features.reset()


def _gates(gates):
    jax_features.set_gates(gates)
    port_features.set_gates(gates)


def _outcome(result) -> dict:
    out = {}
    for name, res in sorted(result.items()):
        ta = res.assignment
        out[name] = (res.failure, None if ta is None else (
            list(ta.levels), [(list(d.values), d.count)
                              for d in ta.domains]))
    return out


# ---------------------------------------------------------------------------
# Scenarios: p -> (snapshot, requests, find_topology_assignments kwargs)
# ---------------------------------------------------------------------------


def s_required_rack(p):
    return p.build(p.nodes()), [p.req(p.podset(count=3, required=RACK))], {}


def s_required_rack_too_big(p):
    return p.build(p.nodes()), [p.req(p.podset(count=9, required=RACK))], {}


def s_preferred_falls_back(p):
    return p.build(p.nodes()), [p.req(p.podset(count=9, preferred=RACK))], {}


def s_preferred_spans_blocks(p):
    return (p.build(p.nodes(blocks=2, racks=1)),
            [p.req(p.podset(count=10, preferred=RACK))], {})


def s_unconstrained_least_free(p):
    return (p.build(p.nodes()),
            [p.req(p.podset(count=5, unconstrained=True))], {})


def s_unconstrained_best_fit(p):
    return (p.build(p.nodes(), profile_mixed=False),
            [p.req(p.podset(count=5, unconstrained=True))], {})


def s_required_host_best_fit(p):
    nodes = [p.t.Node(name="big", labels={BLOCK: "b0", RACK: "r0"},
                      allocatable={"cpu": 8000}),
             p.t.Node(name="small", labels={BLOCK: "b0", RACK: "r0"},
                      allocatable={"cpu": 2000})]
    return p.build(nodes), [p.req(p.podset(count=2, required=HOST))], {}


def s_minimizes_domains(p):
    return p.build(p.nodes()), [p.req(p.podset(count=4, required=RACK))], {}


def s_tas_usage(p):
    snap = p.build(p.nodes(racks=1, hosts=1))
    snap.add_tas_usage(("n-0-0-0",), {"cpu": 1000}, 2)
    return snap, [p.req(p.podset(count=3, required=RACK))], {}


def s_simulate_empty(p):
    snap, reqs, _ = s_tas_usage(p)
    return snap, reqs, {"simulate_empty": True}


def s_pods_limit(p):
    nodes = [p.t.Node(name="n0", labels={BLOCK: "b0", RACK: "r0"},
                      allocatable={"cpu": 100000, "pods": 3})]
    return p.build(nodes), [p.req(p.podset(count=4, cpu=1,
                                           required=HOST))], {}


TAINT = {"key": "gpu", "value": "true", "effect": "NoSchedule"}


def s_untolerated_taint(p):
    return (p.build(p.nodes(racks=1, hosts=1, taints=[TAINT])),
            [p.req(p.podset(required=HOST))], {})


def s_tolerated_taint(p):
    return (p.build(p.nodes(racks=1, hosts=1, taints=[TAINT])),
            [p.req(p.podset(required=HOST, tolerations=[
                {"key": "gpu", "operator": "Exists"}]))], {})


def s_flavor_tolerations(p):
    return (p.build(p.nodes(racks=1, hosts=1, taints=[TAINT]),
                    tolerations=[p.t.Toleration(key="gpu",
                                                operator="Exists")]),
            [p.req(p.podset(required=HOST))], {})


def s_node_selector(p):
    nodes = p.nodes(racks=1, hosts=2)
    nodes[0].labels["zone"] = "a"
    nodes[1].labels["zone"] = "b"
    return p.build(nodes), [p.req(p.podset(
        count=8, required=RACK, node_selector={"zone": "a"}))], {}


def s_not_ready(p):
    nodes = p.nodes(racks=1, hosts=2)
    nodes[0].ready = False
    return p.build(nodes), [p.req(p.podset(count=8, required=RACK))], {}


def s_slices_per_rack(p):
    return p.build(p.nodes(racks=2, hosts=2)), [p.req(p.podset(
        count=8, preferred=BLOCK, podset_slice_required_topology=RACK,
        podset_slice_size=4))], {}


def s_slice_not_divisible(p):
    return p.build(p.nodes()), [p.req(p.podset(
        count=5, preferred=BLOCK, podset_slice_required_topology=RACK,
        podset_slice_size=4))], {}


def s_slice_bigger_than_rack(p):
    return p.build(p.nodes()), [p.req(p.podset(
        count=9, required=BLOCK, podset_slice_required_topology=RACK,
        podset_slice_size=9))], {}


def s_host_slices(p):
    return p.build(p.nodes(racks=3, hosts=3)), [p.req(p.podset(
        count=6, cpu=1500, required=RACK,
        podset_slice_required_topology=HOST, podset_slice_size=2))], {}


def _leader_group(p, workers=4, leader_count=1, w_cpu=1000, l_cpu=500,
                  level=RACK, extra=()):
    ws = p.podset("workers", count=workers, cpu=w_cpu, required=level,
                  podset_group_name="g")
    ld = p.podset("leader", count=leader_count, cpu=l_cpu, required=level,
                  podset_group_name="g")
    return [p.req(ws, group="g"), p.req(ld, group="g"), *extra]


def s_leader_group(p):
    return p.build(p.nodes(racks=2, hosts=2)), _leader_group(p), {}


def s_leader_first_podset(p):
    reqs = _leader_group(p, workers=6, w_cpu=4000, l_cpu=8000)
    return (p.build(p.nodes(racks=3, hosts=4, cpu=16000)),
            [reqs[1], reqs[0]], {})


def s_leader_tight(p):
    return (p.build(p.nodes(racks=2, hosts=2)),
            _leader_group(p, workers=7, l_cpu=1500), {})


def s_three_podset_group(p):
    extra = [p.req(p.podset("third", required=RACK,
                            podset_group_name="g"), group="g")]
    return p.build(p.nodes()), _leader_group(p, extra=extra), {}


def s_multi_count_leader(p):
    return (p.build(p.nodes()),
            _leader_group(p, workers=4, leader_count=2), {})


def s_sequential_groups(p):
    return p.build(p.nodes(racks=2, hosts=2)), [
        p.req(p.podset("a", count=8, required=RACK)),
        p.req(p.podset("b", count=8, required=RACK))], {}


def _admitted(p, hosts=(("n-0-0-0", 2), ("n-0-0-1", 2)), unhealthy=()):
    t = p.t
    wl = t.Workload(name="wl", uid=7, podsets=[t.PodSet(
        name="main", count=4, requests={"cpu": 1000},
        topology_request=t.PodSetTopologyRequest(required=BLOCK))])
    wl.status.admission = t.Admission(
        cluster_queue="cq", podset_assignments=[t.PodSetAssignment(
            name="main", flavors={"cpu": "default"},
            resource_usage={"cpu": 4000}, count=4,
            topology_assignment=t.TopologyAssignment(
                levels=[HOST], domains=[
                    t.TopologyDomainAssignment([h], c) for h, c in hosts]))])
    wl.status.unhealthy_nodes = list(unhealthy)
    return wl


def s_replace_other_node(p):
    wl = _admitted(p, unhealthy=["n-0-0-0"])
    snap = p.build([n for n in p.nodes(racks=2, hosts=2)
                    if n.name != "n-0-0-0"])
    snap.add_tas_usage(("n-0-0-1",), {"cpu": 1000}, 2)
    return snap, [p.req(wl.podsets[0])], {"workload": wl}


def s_replace_avoids_unhealthy(p):
    wl = _admitted(p, unhealthy=["n-0-0-0"])
    return (p.build(p.nodes(racks=2, hosts=2)), [p.req(wl.podsets[0])],
            {"workload": wl})


def s_replace_impossible(p):
    wl = _admitted(p, unhealthy=["n-0-0-0"])
    snap = p.build([n for n in p.nodes(racks=1, hosts=2)
                    if n.name != "n-0-0-0"])
    snap.add_tas_usage(("n-0-0-1",), {"cpu": 1000}, 4)
    return snap, [p.req(wl.podsets[0])], {"workload": wl}


def s_replace_two_unhealthy(p):
    wl = _admitted(p, unhealthy=["n-0-0-0", "n-0-0-1"])
    return (p.build(p.nodes(racks=2, hosts=2)), [p.req(wl.podsets[0])],
            {"workload": wl})


def s_replace_gate_off(p):
    _gates({"TASFailedNodeReplacement": False})
    return s_replace_avoids_unhealthy(p)


def s_balanced_preferred(p):
    _gates({"TASBalancedPlacement": True})
    return p.build(p.nodes(blocks=2, racks=3, hosts=2)), [p.req(p.podset(
        count=12, preferred=BLOCK, podset_slice_required_topology=RACK,
        podset_slice_size=2))], {}


def s_balanced_leader(p):
    _gates({"TASBalancedPlacement": True})
    ws = p.podset("workers", count=9, preferred=RACK,
                  podset_group_name="g")
    ld = p.podset("leader", count=1, cpu=500, preferred=RACK,
                  podset_group_name="g")
    return (p.build(p.nodes(racks=3, hosts=2)),
            [p.req(ws, group="g"), p.req(ld, group="g")], {})


def s_balanced_uneven(p):
    _gates({"TASBalancedPlacement": True})
    snap = p.build(p.nodes(racks=3, hosts=3))
    snap.add_tas_usage(("n-0-0-0",), {"cpu": 1000}, 3)
    snap.add_tas_usage(("n-0-1-2",), {"cpu": 1000}, 2)
    return snap, [p.req(p.podset(count=14, preferred=RACK))], {}


def _multi_layer(p, inner_size=2):
    _gates({"TASMultiLayerTopology": True})
    C = p.t.PodSetSliceConstraint
    return p.build(p.nodes(blocks=2, racks=2, hosts=3)), [p.req(p.podset(
        count=16, required=BLOCK, podset_slice_required_topology=RACK,
        podset_slice_size=8,
        podset_slice_constraints=[C(topology=RACK, size=8),
                                  C(topology=HOST, size=inner_size)]))], {}


def s_multi_layer(p):
    return _multi_layer(p)


def s_multi_layer_bad_size(p):
    return _multi_layer(p, inner_size=3)


SCENARIOS = {name[2:]: fn for name, fn in sorted(globals().items())
             if name.startswith("s_")}


def _run(scenario, fill):
    out = {}
    for name in ("jax", "port"):
        snap, reqs, kw = scenario(Pkg(name))
        assert snap.use_device_fill == (fill == "device_fill")
        out[name] = _outcome(snap.find_topology_assignments(reqs, **kw))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, fill_mode):
    out = _run(SCENARIOS[name], fill_mode)
    assert out["port"] == out["jax"]


def test_scenarios_reach_the_reference_outcomes(fill_mode):
    """A few of tests/test_tas.py's assertions, on the port."""
    def run(name):
        snap, reqs, kw = SCENARIOS[name](Pkg("port"))
        return _outcome(snap.find_topology_assignments(reqs, **kw))
    assert "allows to fit only 8 out of 9" in run(
        "required_rack_too_big")["main"][0]
    assert run("required_host_best_fit")["main"][1][1] == [(["small"], 2)]
    assert "taints: 1" in run("untolerated_taint")["main"][0]
    assert "nodeSelector: 1" in run("node_selector")["main"][0]
    doms = dict((v[0], c) for v, c in run(
        "replace_avoids_unhealthy")["main"][1][1])
    assert "n-0-0-0" not in doms and sum(doms.values()) == 4
    out = run("leader_group")
    racks = {v[0].split("-")[2] for name in ("workers", "leader")
             for v, _ in out[name][1][1]}
    assert len(racks) == 1


# ---------------------------------------------------------------------------
# Seeded random trees
# ---------------------------------------------------------------------------


def _random_case(seed: int):
    """A random 3-level tree with usage, and 3-5 podset requests (plain,
    sliced, leader groups); plain Python values, built per package."""
    rng = np.random.default_rng(seed)
    nodes = []
    for b in range(int(rng.integers(1, 3))):
        for r in range(int(rng.integers(1, 4))):
            for h in range(int(rng.integers(1, 5))):
                alloc = {"cpu": int(rng.integers(0, 17)) * 500}
                if rng.random() < 0.3:
                    alloc["pods"] = int(rng.integers(1, 8))
                nodes.append((f"n-{b}-{r}-{h}", f"b{b}", f"b{b}-r{r}",
                              alloc))
    usage = [(nodes[int(i)][0], int(rng.integers(1, 4)) * 250,
              int(rng.integers(1, 3)))
             for i in rng.integers(0, len(nodes), size=int(
                 rng.integers(0, 4)))]
    levels = [BLOCK, RACK, HOST]
    reqs = []
    for i in range(int(rng.integers(3, 6))):
        kind = int(rng.integers(0, 4))
        level = levels[int(rng.integers(0, 3))]
        mode = ["required", "preferred", "unconstrained"][
            int(rng.integers(0, 3))]
        tr = {mode: True} if mode == "unconstrained" else {mode: level}
        cpu = int(rng.integers(1, 5)) * 250
        if kind == 0:
            reqs.append([(f"p{i}", int(rng.integers(1, 13)), cpu, tr, None)])
        elif kind == 1:
            lvl = int(rng.integers(0, 3))
            size = int(rng.integers(1, 4))
            tr = {"required" if mode == "required" else "preferred":
                  levels[lvl],
                  "podset_slice_required_topology":
                      levels[int(rng.integers(lvl, 3))],
                  "podset_slice_size": size}
            reqs.append([(f"p{i}", size * int(rng.integers(1, 5)), cpu, tr,
                          None)])
        else:
            g = f"g{i}"
            gtr = {"required" if mode == "required" else "preferred":
                   level, "podset_group_name": g}
            reqs.append([(f"w{i}", int(rng.integers(1, 9)), cpu, gtr, g),
                         (f"l{i}", 1, int(rng.integers(1, 5)) * 250, gtr,
                          g)])
    return nodes, usage, reqs


def _random_build(p, case):
    nodes, usage, reqs = case
    snap = p.build([p.t.Node(name=n, labels={BLOCK: b, RACK: r},
                             allocatable=dict(a)) for n, b, r, a in nodes])
    for host, cpu, count in usage:
        snap.add_tas_usage((host,), {"cpu": cpu}, count)
    out = []
    for group in reqs:
        for name, count, cpu, tr, g in group:
            out.append(p.req(p.podset(name, count=count, cpu=cpu, **tr),
                             group=g))
    return snap, out


@pytest.mark.parametrize("seed", range(12))
def test_random_trees_match_jax(seed, fill_mode):
    case = _random_case(seed)
    out = {}
    for name in ("jax", "port"):
        snap, reqs = _random_build(Pkg(name), case)
        out[name] = _outcome(snap.find_topology_assignments(reqs))
    assert out["port"] == out["jax"]


def _states(snap) -> list:
    return [(d.level_values, d.state, d.state_with_leader, d.leader_state,
             d.slice_state, d.slice_state_with_leader)
            for d in sorted(snap.domains.values(),
                            key=lambda d: d.level_values)]


@pytest.mark.parametrize("seed", range(6))
def test_fill_in_counts_states_match_jax(seed, fill_mode):
    """``_fill_in_counts`` itself: every domain's five states and the
    exclusion stats, for each request of a random case with its leader,
    slice size and slice level."""
    case = _random_case(100 + seed)
    got = {}
    for name in ("jax", "port"):
        snap, reqs = _random_build(Pkg(name), case)
        rows = []
        for i, tr in enumerate(reqs):
            leader = reqs[i + 1] if (
                tr.podset_group_name and i + 1 < len(reqs)
                and reqs[i + 1].podset_group_name == tr.podset_group_name
            ) else None
            t = tr.podset.topology_request
            size = t.podset_slice_size or 1
            level = (snap.level_index(t.podset_slice_required_topology)
                     if t.podset_slice_required_topology else 2)
            stats = snap._fill_in_counts(tr, leader, {}, False, size, level,
                                         None)
            rows.append((_states(snap), stats))
        got[name] = rows
    assert got["port"] == got["jax"]


def test_pallas_interpret_leaf_pass(monkeypatch):
    """Device fill with the JAX side's Pallas leaf kernel in interpret
    mode: leader groups, slices and a random tree."""
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "1")
    _gates({"TASDeviceFillCounts": True})
    try:
        for scenario in (s_leader_group, s_host_slices, s_slices_per_rack):
            out = _run(scenario, "device_fill")
            assert out["port"] == out["jax"]
        case = _random_case(3)
        out = {}
        for name in ("jax", "port"):
            snap, reqs = _random_build(Pkg(name), case)
            out[name] = _outcome(snap.find_topology_assignments(reqs))
        assert out["port"] == out["jax"]
    finally:
        jax_features.reset()
        port_features.reset()


def test_device_fill_needs_cuda_unless_cpu_is_asked():
    """With the gate on, a snapshot on "cuda" raises without a CUDA
    device (no quiet host fallback); with it off no device is read."""
    import torch

    p = Pkg("port")
    ps = p.podset(count=3, required=RACK)
    snap = port_snap.build_tas_flavor_snapshot(
        "default", [BLOCK, RACK, HOST], p.nodes())
    assert snap.device == "cuda" and not snap.use_device_fill
    assert snap.find_topology_assignments([p.req(ps)])["main"].failure == ""
    port_features.set_gates({"TASDeviceFillCounts": True})
    try:
        snap = port_snap.build_tas_flavor_snapshot(
            "default", [BLOCK, RACK, HOST], p.nodes())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA device requested"):
                snap.find_topology_assignments([p.req(ps)])
    finally:
        port_features.reset()


def test_set_gates_refuses_unknown_names():
    with pytest.raises(KeyError):
        port_features.set_gates({"NoSuchGate": True})
    with pytest.raises(KeyError):
        port_features.enabled("NoSuchGate")
