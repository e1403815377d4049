"""The port's TAS leaf pass (kueue_oss_tpu_torch/solver/cuda_tas.py) on
the CPU against the JAX package's Pallas kernel (interpret mode) and its
jnp reference, on the shapes of tests/test_pallas_tas.py plus R = 130
(beyond one Pallas lane row: reference only on the JAX side) and
negative capacities. Tolerance 0. The CUDA kernel itself is compared
with the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from kueue_oss_tpu.solver.pallas_tas import (
    leaf_states as jax_leaf_states,
    leaf_states_reference as jax_leaf_states_reference,
)
from kueue_oss_tpu_torch.solver import cuda_tas


def _port(cap, per_pod, leader, has_leader):
    return cuda_tas.leaf_states(torch.as_tensor(cap),
                                torch.as_tensor(per_pod),
                                torch.as_tensor(leader),
                                torch.tensor(has_leader))


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("st", "swl", "ls")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def _inputs(seed, R=None, lo=0):
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 700))
    R = int(rng.integers(1, 9)) if R is None else R
    cap = rng.integers(lo, 200, size=(D, R)).astype(np.int32)
    per_pod = rng.integers(0, 6, size=(R,)).astype(np.int32)
    leader = rng.integers(0, 6, size=(R,)).astype(np.int32)
    return cap, per_pod, leader, bool(rng.integers(0, 2))


@pytest.mark.parametrize("seed", range(6))
def test_leaf_states_matches_pallas_interpret(seed):
    cap, per_pod, leader, has_leader = _inputs(seed)
    want = jax_leaf_states(cap, per_pod, leader, has_leader, interpret=True)
    _assert_equal(_port(cap, per_pod, leader, has_leader), want)
    _assert_equal(_port(cap, per_pod, leader, has_leader),
                  jax_leaf_states_reference(cap, per_pod, leader,
                                            has_leader))


def test_all_zero_requests_mean_unbounded():
    cap = np.zeros((4, 3), dtype=np.int32)
    zero = np.zeros(3, np.int32)
    want = jax_leaf_states(cap, zero, zero, False, interpret=True)
    got = _port(cap, zero, zero, False)
    _assert_equal(got, want)
    assert got[0].tolist() == [1 << 30] * 4


@pytest.mark.parametrize("has_leader", [False, True])
def test_wide_resource_vocabulary_r130(has_leader):
    cap, per_pod, leader, _ = _inputs(11, R=130)
    _assert_equal(_port(cap, per_pod, leader, has_leader),
                  jax_leaf_states_reference(cap, per_pod, leader,
                                            has_leader))


@pytest.mark.parametrize("seed", range(3))
def test_negative_capacities_floor(seed):
    cap, per_pod, leader, has_leader = _inputs(100 + seed, lo=-300)
    want = jax_leaf_states(cap, per_pod, leader, has_leader, interpret=True)
    _assert_equal(_port(cap, per_pod, leader, has_leader), want)


def test_cpu_tensors_do_not_launch():
    before = cuda_tas.leaf_states.launches
    cap, per_pod, leader, has_leader = _inputs(3)
    _port(cap, per_pod, leader, has_leader)
    assert cuda_tas.leaf_states.launches == before


def test_cuda_request_raises_without_cuda():
    """Asking for the card where there is none raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    from kueue_oss_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

    class ReportsCuda(torch.Tensor):
        """CPU storage that reports a CUDA device: the wrapper must take
        the kernel route and fail there, not compute the plain version."""

        @property
        def device(self):
            return torch.device("cuda")

    cap, per_pod, leader, _ = _inputs(4)
    args = [torch.as_tensor(a).as_subclass(ReportsCuda)
            for a in (cap, per_pod, leader)]
    before = cuda_tas.leaf_states.launches
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        cuda_tas.leaf_states(*args, False)
    assert cuda_tas.leaf_states.launches == before


def test_non_cpu_tensors_never_take_the_plain_version():
    cap, per_pod, leader, _ = _inputs(5)
    before = cuda_tas.leaf_states.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tas.leaf_states(torch.as_tensor(cap, device="meta"),
                             torch.as_tensor(per_pod, device="meta"),
                             torch.as_tensor(leader, device="meta"),
                             False)
    assert cuda_tas.leaf_states.launches == before
