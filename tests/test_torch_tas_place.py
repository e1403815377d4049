"""The sequential TAS placer as one kernel (cuda_tas.tas_place_sequential)
on the CPU: its plain version against the JAX package's sequential
placer, with the JAX leaf pass forced through the Pallas kernel in
interpret mode (KUEUE_TPU_PALLAS=1), on random 2-, 3- and 4-level trees
with slices, leaders, the least-free profile and pre-rejected rows, and
on the drain's 1 x 10 x 64 tree; plus the tree's child offsets, the
kernel state's footprint, the CUDA route without CUDA and M = 0.
Tolerance 0: ints match exactly. The CUDA kernel itself is compared with
the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_oss_tpu.solver import tas_kernels as jax_tk
from kueue_oss_tpu_torch import scenarios
from kueue_oss_tpu_torch.scenarios import PLACER_INPUTS
from kueue_oss_tpu_torch.solver import cuda_tas
from kueue_oss_tpu_torch.solver import tas_kernels as port_tk


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_PALLAS", "1")


def _compare_with_jax(parents, cap, req):
    want = jax_tk.make_sequential_placer_ext(parents)(
        jnp.asarray(cap), *[jnp.asarray(req[k]) for k in PLACER_INPUTS])
    before = (cuda_tas.tas_place_sequential.launches,
              cuda_tas.leaf_states.launches)
    got = cuda_tas.tas_place_sequential(
        cuda_tas.PlacerTree(parents), torch.as_tensor(cap),
        *[torch.as_tensor(req[k]) for k in PLACER_INPUTS])
    assert before == (cuda_tas.tas_place_sequential.launches,
                      cuda_tas.leaf_states.launches)
    for g, w, name in zip(got, want, ("sels", "leads", "oks", "cap")):
        assert g.dtype == (torch.bool if name == "oks" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return np.asarray(want[2])


@pytest.mark.parametrize("n_levels,seed", [(2, 0), (3, 0), (4, 0)])
def test_plain_version_matches_jax_sequential_placer(n_levels, seed):
    parents, cap = scenarios.random_placer_tree(n_levels, seed)
    rng = np.random.default_rng(seed + 400)
    req = scenarios.random_placer_requests(rng, n_levels, cap.shape[1], 16,
                                           pre_rejected=0.2)
    assert req["has_leader"].any() and req["least_free"].any()
    assert (req["slice_size"] > 1).any() and (req["count"] == 0).any()
    assert req["required"].any() and req["unconstrained"].any()
    assert (~req["required"] & ~req["unconstrained"]).any()  # preferred
    oks = _compare_with_jax(parents, cap, req)
    assert oks.any() and not oks.all(), "vacuous: all or nothing placed"


def test_plain_version_matches_jax_on_the_drain_tree():
    parents, cap, req = scenarios.drain_placer_batch(M=40)
    assert [p.shape[0] for p in parents] == [1, 10, 640]
    assert cap.shape == (640, 2)
    oks = _compare_with_jax(parents, cap, req)
    assert oks.all()


def test_child_offsets_match_a_direct_count():
    parents, _ = scenarios.random_placer_tree(4, 7, min_children=0,
                                              max_children=6)
    offsets = cuda_tas.child_offsets(parents)
    assert len(offsets) == len(parents) - 1
    for l, off in enumerate(offsets, start=1):
        n_up = parents[l - 1].shape[0]
        counts = np.asarray([(parents[l] == p).sum() for p in range(n_up)])
        assert off.dtype == np.int32 and off.shape == (n_up + 1,)
        assert off[0] == 0 and off[-1] == parents[l].shape[0]
        np.testing.assert_array_equal(np.diff(off), counts)
        for p in range(n_up):
            assert (parents[l][off[p]:off[p + 1]] == p).all()
    tree = cuda_tas.PlacerTree(parents)
    sizes = [p.shape[0] for p in parents]
    assert tree.flat[:len(parents)].tolist() == sizes
    assert tree.flat.shape == (len(parents) + 3 * sum(sizes),)


@pytest.mark.parametrize("bad", [
    [np.zeros(2, np.int32), np.asarray([0, 1, 0], np.int32)],  # decreasing
    [np.zeros(2, np.int32), np.asarray([0, 2], np.int32)],     # out of range
    [np.zeros(1, np.int32), np.zeros(0, np.int32)],            # empty level
])
def test_malformed_parents_raise(bad):
    with pytest.raises(ValueError):
        cuda_tas.PlacerTree(bad)


def test_footprint_picks_shared_for_the_drain_and_global_above_227kb():
    drain = cuda_tas.PlacerTree(scenarios.drain_placer_batch(M=1)[0])
    assert drain.state_words(2) == (2 * 3 + 1 + 640 * 2 + 10 * 651
                                    + 3 * 640 + 5 * 10)
    assert drain.footprint_bytes(2) < 48 * 1024
    assert drain.uses_shared(2)
    wide = cuda_tas.PlacerTree(scenarios.drain_placer_batch(
        M=1, n_racks=64, n_hosts=128)[0])
    assert wide.footprint_bytes(2) > cuda_tas.SHARED_LIMIT_BYTES
    assert not wide.uses_shared(2)
    # the limit is 227 KB of one block's shared memory, static included
    assert cuda_tas.SHARED_LIMIT_BYTES == 227 * 1024


def test_m_zero_returns_empty_outputs():
    parents, cap, req = scenarios.drain_placer_batch(M=0)
    sels, leads, oks, after = cuda_tas.tas_place_sequential(
        cuda_tas.PlacerTree(parents), torch.as_tensor(cap),
        *[torch.as_tensor(req[k]) for k in PLACER_INPUTS])
    assert sels.shape == (0, 640) and sels.dtype == torch.int32
    assert leads.shape == (0,) and oks.shape == (0,)
    assert oks.dtype == torch.bool
    np.testing.assert_array_equal(after.numpy(), cap)


def test_leaf_fn_is_the_sequential_placers_leaf_pass():
    parents, cap, req = scenarios.drain_placer_batch(M=5)
    calls = []

    def leaf_fn(*args):
        calls.append(args[0].shape)
        return cuda_tas.leaf_states_reference(*args)

    args = [torch.as_tensor(cap)] + [torch.as_tensor(req[k])
                                     for k in PLACER_INPUTS]
    got = port_tk.make_sequential_placer_ext(parents, "cpu",
                                             leaf_fn=leaf_fn)(*args)
    want = port_tk.make_sequential_placer_ext(parents, "cpu")(*args)
    assert calls == [(640, 2)] * 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _ReportsCuda(torch.Tensor):
    """CPU storage that reports a CUDA device: the wrapper must take the
    kernel route and fail there, not compute the plain version."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_tensors_without_cuda_raise_and_never_take_the_plain_version(
        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")

    def plain(*_args):
        raise AssertionError("the CUDA route took the plain version")

    monkeypatch.setattr(cuda_tas, "tas_place_sequential_reference", plain)
    parents, cap, req = scenarios.drain_placer_batch(M=3)
    args = [torch.as_tensor(cap).as_subclass(_ReportsCuda)] + [
        torch.as_tensor(req[k]) for k in PLACER_INPUTS]
    before = cuda_tas.tas_place_sequential.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_tas.tas_place_sequential(cuda_tas.PlacerTree(parents), *args)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tas.tas_place_sequential(
            cuda_tas.PlacerTree(parents), torch.as_tensor(cap, device="meta"),
            *args[1:])
    assert cuda_tas.tas_place_sequential.launches == before
