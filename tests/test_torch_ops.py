"""The port's int32 primitives (kueue_oss_tpu_torch/solver/ops.py)
against the JAX operations the drains were written with: segment
reductions with empty segments, stable sorts with ties, floor division
with negative numerators, int32 prefix sums. Tolerance 0: ints match
exactly."""


import torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_oss_tpu_torch.solver import ops


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ["sum", "min", "max"])
def test_segment_reductions_match_jax(seed, name):
    rng = np.random.default_rng(seed)
    n, segs = int(rng.integers(1, 60)), int(rng.integers(1, 12))
    data = rng.integers(-1000, 1000, size=n).astype(np.int32)
    # ids drawn from a subset so some segments stay empty
    ids = rng.integers(0, max(1, segs - 3), size=n).astype(np.int32)
    want = getattr(jax.ops, f"segment_{name}")(
        jnp.asarray(data), jnp.asarray(ids), num_segments=segs)
    got = getattr(ops, f"segment_{name}")(_t(data), _t(ids), segs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_segment_identities():
    data = _t(np.array([5], np.int32))
    ids = _t(np.array([0], np.int32))
    assert ops.segment_min(data, ids, 3).tolist() == [5] + [2**31 - 1] * 2
    assert ops.segment_max(data, ids, 3).tolist() == [5] + [-2**31] * 2
    assert ops.segment_sum(data, ids, 3).tolist() == [5, 0, 0]


def test_segment_max_2d_rows():
    rng = np.random.default_rng(9)
    data = rng.integers(-50, 50, size=(20, 3)).astype(np.int32)
    ids = rng.integers(0, 4, size=20).astype(np.int32)
    want = jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=6)
    got = ops.segment_max(_t(data), _t(ids), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_lexsort_matches_jax_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    keys = [rng.integers(0, 3, size=n).astype(np.int32) for _ in range(4)]
    want = jnp.lexsort(tuple(jnp.asarray(k) for k in keys))
    got = ops.lexsort([_t(k) for k in keys])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_single_key_lexsort_is_jax_stable_argsort(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=100).astype(np.int32)
    got = ops.lexsort([_t(x)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(x))))


def test_floor_div_negative_numerators():
    a = np.arange(-17, 18, dtype=np.int32)
    for b in (1, 2, 3, 7):
        got = ops.floor_div(_t(a), b)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.asarray(a) // b))


def test_cumsum_and_cummax_int32():
    x = np.array([2**30, 2**30, 5, -7, 2**30], np.int32)
    got = ops.cumsum(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x))))
    y = np.array([-1, 3, -1, 2, 9, -1], np.int32)
    want = jax.lax.associative_scan(jnp.maximum, jnp.asarray(y))
    np.testing.assert_array_equal(ops.cummax(_t(y)).numpy(),
                                  np.asarray(want))


def test_sum_and_arange_are_int32():
    x = _t(np.array([2**30] * 4, np.int32))
    assert ops.sum_i32(x).dtype == torch.int32
    assert int(ops.sum_i32(x)) == int(np.asarray(jnp.sum(jnp.asarray(
        np.array([2**30] * 4, np.int32)))))
    assert ops.arange(5, "cpu").dtype == torch.int32
