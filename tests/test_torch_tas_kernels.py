"""The port's TAS placer (kueue_oss_tpu_torch/solver/tas_kernels.py) on
the CPU against the JAX package's, with the JAX leaf pass forced through
the Pallas kernel in interpret mode (KUEUE_TPU_PALLAS=1): phase-1
fill_counts_ext at every level and key, the extended placer, and the
sequential placer, on random 2- and 3-level trees with slices, leaders
and the least-free profile. Tolerance 0: ints match exactly."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_oss_tpu.solver import tas_kernels as jax_tk
from kueue_oss_tpu_torch.solver import tas_kernels as port_tk


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "1")


def _tree(n_levels, seed):
    """Random lex-ordered tree: nondecreasing parent arrays, every inner
    domain with at least one child."""
    rng = np.random.default_rng(seed)
    parents = [np.zeros(int(rng.integers(1, 3)), np.int32)]
    for _ in range(1, n_levels):
        n_up = parents[-1].shape[0]
        kids = rng.integers(1, 5, size=n_up)
        parents.append(np.repeat(np.arange(n_up), kids).astype(np.int32))
    R = int(rng.integers(1, 4))
    cap = rng.integers(0, 24, size=(parents[-1].shape[0], R)).astype(
        np.int32)
    return parents, cap


TREES = [(2, 1), (3, 2), (3, 5)]


def _case(rng, n_levels, R):
    """One placement request the host pre-checks would accept."""
    leaf = n_levels - 1
    level = int(rng.integers(0, n_levels))
    slice_level = int(rng.integers(level, n_levels))
    slice_size = int(rng.integers(1, 4))
    count = slice_size * int(rng.integers(1, 6))
    unconstrained = bool(rng.integers(0, 4) == 0)
    required = (not unconstrained) and bool(rng.integers(0, 2))
    if unconstrained:
        level = leaf
        slice_level = leaf
    has_leader = bool(rng.integers(0, 2))
    return dict(
        per_pod=rng.integers(0, 4, size=R).astype(np.int32),
        count=np.int32(count), level=np.int32(level),
        required=np.bool_(required), unconstrained=np.bool_(unconstrained),
        least_free=np.bool_(unconstrained and bool(rng.integers(0, 2))),
        slice_size=np.int32(slice_size), slice_level=np.int32(slice_level),
        leader=(rng.integers(0, 3, size=R) * has_leader).astype(np.int32),
        has_leader=np.bool_(has_leader))


_ORDER = ("per_pod", "count", "level", "required", "unconstrained",
          "least_free", "slice_size", "slice_level", "leader", "has_leader")


def _port_args(case):
    return [torch.as_tensor(np.asarray(case[k])) for k in _ORDER]


def _jax_args(case):
    return [jnp.asarray(case[k]) for k in _ORDER]


def test_build_levels_matches_jax_and_converts():
    """The dense tree of a TAS store with admitted usage assumed, built
    by each package from its own snapshot; the JAX arrays carried across
    with convert.levels_from_arrays give the same TASLevels."""
    from kueue_oss_tpu.api import types as jax_types
    from kueue_oss_tpu.core.snapshot import build_snapshot as jax_snapshot
    from kueue_oss_tpu.core.store import Store as JaxStore
    from kueue_oss_tpu_torch import convert
    from kueue_oss_tpu_torch.api import types as port_types
    from kueue_oss_tpu_torch.core.snapshot import (
        build_snapshot as port_snapshot,
    )
    from kueue_oss_tpu_torch.core.store import Store as PortStore
    from kueue_oss_tpu_torch.scenarios import tas_drain_store

    kw = dict(n_racks=3, n_hosts=5, n_cohorts=1, n_cqs=2, n_workloads=6)
    levels = []
    for t, store_cls, snap_fn, tk in (
            (jax_types, JaxStore, jax_snapshot, jax_tk),
            (port_types, PortStore, port_snapshot, port_tk)):
        store = tas_drain_store(t, store_cls, **kw)
        wl = store.workloads["default/w0"]
        wl.status.admission = t.Admission(
            cluster_queue="cq-0-0", podset_assignments=[t.PodSetAssignment(
                name="main", flavors={"cpu": "tas"},
                resource_usage={"cpu": 40}, count=2,
                topology_assignment=t.TopologyAssignment(
                    levels=["kubernetes.io/hostname"],
                    domains=[t.TopologyDomainAssignment(
                        values=["n-1-2"], count=2)]))])
        wl.podsets[0].requests = {"cpu": 20}
        wl.set_condition("QuotaReserved", True)
        store.update_workload(wl)
        levels.append(tk.build_levels(snap_fn(store).tas_flavors["tas"]))
    want, got = levels
    assert got.resources == want.resources == ["cpu", "pods"]
    assert got.leaf_names == want.leaf_names
    np.testing.assert_array_equal(got.leaf_capacity, want.leaf_capacity)
    assert got.leaf_capacity.min() < 96  # the admitted usage is assumed
    for g, w in zip(got.parents, want.parents, strict=True):
        np.testing.assert_array_equal(g, w)
    carried = convert.levels_from_arrays(want.parents, want.leaf_capacity,
                                         want.leaf_names, want.resources)
    assert (carried.leaf_names, carried.resources) == (got.leaf_names,
                                                       got.resources)
    np.testing.assert_array_equal(carried.leaf_capacity, got.leaf_capacity)
    for g, c in zip(got.parents, carried.parents, strict=True):
        np.testing.assert_array_equal(c, g)
    with pytest.raises(TypeError, match="leaf_capacity"):
        convert.levels_from_arrays(want.parents,
                                   want.leaf_capacity.astype(np.int64),
                                   want.leaf_names, want.resources)


@pytest.mark.parametrize("n_levels,seed", TREES)
def test_fill_counts_ext_every_level_and_key(n_levels, seed):
    parents, cap = _tree(n_levels, seed)
    rng = np.random.default_rng(seed + 100)
    R = cap.shape[1]
    for _ in range(3):
        c = _case(rng, n_levels, R)
        want = jax_tk.fill_counts_ext(
            [jnp.asarray(p) for p in parents], jnp.asarray(cap),
            jnp.asarray(c["per_pod"]), jnp.asarray(c["leader"]),
            jnp.asarray(c["has_leader"]), jnp.asarray(c["slice_size"]),
            jnp.asarray(c["slice_level"]))
        got = port_tk.fill_counts_ext(
            [torch.as_tensor(p) for p in parents], torch.as_tensor(cap),
            torch.as_tensor(c["per_pod"]), torch.as_tensor(c["leader"]),
            torch.tensor(bool(c["has_leader"])),
            torch.tensor(int(c["slice_size"]), dtype=torch.int32),
            torch.tensor(int(c["slice_level"]), dtype=torch.int32))
        assert sorted(got) == sorted(want)
        for level in want:
            for key in want[level]:
                assert got[level][key].dtype == torch.int32
                np.testing.assert_array_equal(
                    got[level][key].numpy(), np.asarray(want[level][key]),
                    err_msg=f"level {level} key {key}")


@pytest.mark.parametrize("n_levels,seed", TREES)
def test_placer_ext_matches_jax(n_levels, seed):
    parents, cap = _tree(n_levels, seed)
    jax_place = jax_tk.make_placer_ext(parents)
    port_place = port_tk.make_placer_ext(parents, "cpu")
    rng = np.random.default_rng(seed + 200)
    feasible = 0
    for _ in range(10):
        c = _case(rng, n_levels, cap.shape[1])
        want = jax_place(jnp.asarray(cap), *_jax_args(c)[:8],
                         jnp.asarray(c["leader"]),
                         jnp.asarray(c["has_leader"]))
        a = _port_args(c)
        got = port_place(torch.as_tensor(cap), *a)
        for g, w, name in zip(got, want, ("sel", "leader", "ok")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        feasible += bool(want[2])
    assert feasible, "vacuous: no request was placeable"


@pytest.mark.parametrize("n_levels,seed", TREES)
def test_sequential_placer_ext_matches_jax(n_levels, seed):
    parents, cap = _tree(n_levels, seed)
    rng = np.random.default_rng(seed + 300)
    cases = [_case(rng, n_levels, cap.shape[1]) for _ in range(12)]
    stacked = {k: np.stack([np.asarray(c[k]) for c in cases])
               for k in _ORDER}
    want = jax_tk.make_sequential_placer_ext(parents)(
        jnp.asarray(cap), *[jnp.asarray(stacked[k]) for k in _ORDER])
    got = port_tk.make_sequential_placer_ext(parents, "cpu")(
        torch.as_tensor(cap), *[torch.as_tensor(stacked[k])
                                for k in _ORDER])
    for g, w, name in zip(got, want, ("sels", "leads", "oks", "cap")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert np.asarray(want[2]).any(), "vacuous: nothing was placed"
