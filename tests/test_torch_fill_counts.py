"""The TAS fill-in counts of the port's device fill
(``kueue_oss_tpu_torch/solver/cuda_tas.py`` ``fill_counts`` and its
plain version ``fill_counts_reference``) against the JAX package's
``fill_counts_ext`` with its leaf pass forced through the Pallas kernel
in interpret mode (KUEUE_TPU_PALLAS=1), and the snapshot's
``_device_fill`` on CPU tensors against its host roll-up (``_roll_up``).

Seeded trees of 1-4 levels, R = 1-3, with and without a leader, slice
levels at the leaf, in the middle and at the root, zero-capacity
(filtered) leaves and childless inner domains. Tolerance 0: ints match
exactly. The kernel itself (``csrc/fill_counts.cu``) runs only on the
card: ``chip_smoke.py`` phase 3 holds it against the same plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_oss_tpu.solver import tas_kernels as jax_tk
from kueue_oss_tpu_torch import scenarios
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.solver import cuda_tas
from kueue_oss_tpu_torch.tas import snapshot as port_snap


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "1")


def _request(rng, n_levels, R, *, leader, slice_level):
    """The fill's int32 vector [per_pod R][leader R][has_leader]
    [slice_size][slice_level]."""
    per_pod = rng.integers(0, 4, size=R).astype(np.int32)
    lead = (rng.integers(0, 3, size=R) * leader).astype(np.int32)
    return np.concatenate([per_pod, lead, np.asarray(
        [leader, int(rng.integers(1, 4)), slice_level], np.int32)])


def _cases():
    """(id, parents, capacity, vec): seeded trees with every slice level,
    with and without a leader, some leaves at zero capacity."""
    out = []
    for n_levels, seed in ((1, 0), (2, 1), (3, 2), (3, 3), (4, 4)):
        parents, cap = scenarios.random_placer_tree(
            n_levels, seed, min_children=seed % 2, max_children=5)
        rng = np.random.default_rng(100 + seed)
        cap[rng.random(cap.shape[0]) < 0.25] = 0  # filtered leaves
        R = cap.shape[1]
        for slice_level in sorted({0, n_levels // 2, n_levels - 1}):
            for leader in (0, 1):
                out.append((f"L{n_levels}-s{seed}-R{R}-sl{slice_level}-"
                            f"leader{leader}", parents, cap,
                            _request(rng, n_levels, R, leader=leader,
                                     slice_level=slice_level)))
    return out


CASES = _cases()


def _jax_packed(parents, cap, vec):
    R = cap.shape[1]
    out = jax_tk.fill_counts_ext(
        [jnp.asarray(p) for p in parents], jnp.asarray(cap),
        jnp.asarray(vec[:R]), jnp.asarray(vec[R:2 * R]),
        jnp.asarray(vec[2 * R] > 0), jnp.asarray(vec[2 * R + 1]),
        jnp.asarray(vec[2 * R + 2]))
    return np.concatenate([
        np.stack([np.asarray(out[l][k]) for k in cuda_tas.FILL_KEYS])
        for l in range(len(parents))], axis=1)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fill_counts_reference_matches_jax_fill_counts_ext(case):
    _, parents, cap, vec = case
    tree = cuda_tas.PlacerTree(parents)
    got = cuda_tas.fill_counts_reference(tree, torch.as_tensor(cap),
                                         torch.as_tensor(vec))
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (5, tree.n_domains)
    np.testing.assert_array_equal(got.numpy(), _jax_packed(parents, cap, vec))


def test_fill_counts_takes_the_plain_version_on_cpu_and_counts_no_launch():
    _, parents, cap, vec = CASES[5]
    tree = cuda_tas.PlacerTree(parents)
    before = cuda_tas.launch_counts["fill_counts"]
    got = cuda_tas.fill_counts(tree, torch.as_tensor(cap),
                               torch.as_tensor(vec))
    want = cuda_tas.fill_counts_reference(tree, torch.as_tensor(cap),
                                          torch.as_tensor(vec))
    assert torch.equal(got, want)
    assert cuda_tas.launch_counts["fill_counts"] == before
    assert tree.fill_uses_shared()
    with pytest.raises(ValueError):
        cuda_tas.fill_counts(tree, torch.as_tensor(cap).to("meta"),
                             torch.as_tensor(vec))


def test_fill_state_layout_moves_to_the_output_above_shared_memory():
    """The kernel keeps its five states in shared memory up to 227 KB
    (phase 14's 651-domain tree), else on its output buffer."""
    small = cuda_tas.PlacerTree(scenarios.drain_placer_batch(1)[0])
    big = cuda_tas.PlacerTree(scenarios.drain_placer_batch(
        1, n_racks=200, n_hosts=64)[0])
    assert small.n_domains == 651 and small.fill_uses_shared()
    assert not big.fill_uses_shared()


HOST = "kubernetes.io/hostname"
BLOCK = "cloud/block"
RACK = "cloud/rack"


def _snapshot(seed):
    """A random 3-level TAS snapshot with usage and some tainted nodes
    (filtered leaves) on the CPU device."""
    rng = np.random.default_rng(seed)
    nodes = []
    for b in range(int(rng.integers(1, 3))):
        for r in range(int(rng.integers(1, 4))):
            for h in range(int(rng.integers(1, 6))):
                alloc = {"cpu": int(rng.integers(0, 17)) * 500}
                if rng.random() < 0.3:
                    alloc["pods"] = int(rng.integers(1, 8))
                taints = ([port_types.Taint(key="k", value="v",
                                            effect="NoSchedule")]
                          if rng.random() < 0.2 else [])
                nodes.append(port_types.Node(
                    name=f"n-{b}-{r}-{h}",
                    labels={BLOCK: f"b{b}", RACK: f"b{b}-r{r}"},
                    allocatable=alloc, taints=taints))
    snap = port_snap.build_tas_flavor_snapshot(
        "default", [BLOCK, RACK, HOST], nodes, device="cpu")
    for node in nodes[:int(rng.integers(0, 3))]:
        snap.add_tas_usage((node.name,), {"cpu": 250}, 1)
    return snap


def _tas_request(name, count, cpu, **tr):
    ps = port_types.PodSet(
        name=name, count=count, requests={"cpu": cpu},
        topology_request=port_types.PodSetTopologyRequest(**tr))
    return port_snap.TASPodSetRequest(
        podset=ps, single_pod_requests=dict(ps.requests), count=count,
        flavor="default")


def _states(snap):
    return [(d.level_values, d.state, d.state_with_leader, d.leader_state,
             d.slice_state, d.slice_state_with_leader)
            for d in sorted(snap.domains.values(),
                            key=lambda d: d.level_values)]


@pytest.mark.parametrize("seed", range(4))
def test_device_fill_on_cpu_matches_the_host_roll_up(seed):
    """``_fill_in_counts`` with the device fill (``cuda_tas.fill_counts``
    on CPU tensors) and with the host ``_roll_up``: the same five states
    on every domain and the same exclusion stats, for plain, sliced (slice
    level at the root, the rack and the host) and leader requests."""
    rng = np.random.default_rng(seed)
    requests = []
    for lvl in range(3):
        requests.append((_tas_request(
            "sliced", 2 * int(rng.integers(1, 4)), 250, preferred=RACK,
            podset_slice_required_topology=[BLOCK, RACK, HOST][lvl],
            podset_slice_size=2), None, 2, lvl))
    requests.append((_tas_request("plain", 3, 500, required=RACK), None, 1,
                     2))
    requests.append((_tas_request("workers", 4, 250, preferred=RACK),
                     _tas_request("leader", 1, 1000, preferred=RACK), 1, 2))
    got = {}
    for device_fill in (True, False):
        snap = _snapshot(seed)
        snap.use_device_fill = device_fill
        rows = []
        for tr, leader, size, level in requests:
            stats = snap._fill_in_counts(tr, leader, {}, False, size, level,
                                         None)
            rows.append((_states(snap), stats))
        got[device_fill] = rows
    assert got[True] == got[False]
    # the fills are not trivial: some domain holds pods
    assert any(row[1] > 0 for states, _ in got[True] for row in states)
