"""Shared int32 tensor primitives with JAX's semantics.

The drains are written against ``jax.ops.segment_*``, ``jnp.lexsort``,
``jnp.argsort``, ``//`` and ``cumsum`` with x64 off. PyTorch differs on
each: empty segments, sort stability, truncating division and int64
results. These helpers pin the JAX behaviour so the ports stay
bitwise-equal:

- ``segment_min``/``segment_max`` seed empty segments with the dtype's
  max/min (JAX's identities: INT32_MAX for min, INT32_MIN for max;
  +inf and -inf for floats);
- ``lexsort`` is stable with the LAST key primary;
- every index result is int32;
- integer sums and prefix sums wrap in int32 like the JAX programs;
- ``resource_sum`` replaces the JAX programs' int32 matmuls against the
  FR -> resource one-hot (CUDA has no integer matmul): an exact int32
  sum of each resource's FR columns.

Segment ids must lie in ``[0, num_segments)``; every caller passes
in-range ids.
"""

from __future__ import annotations

from typing import Sequence

import torch

INT32 = torch.int32


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sums along axis 0 (empty segments sum to 0)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _segment_reduce(data, segment_ids, num_segments, reduce, identity):
    out = torch.full((num_segments,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    index = segment_ids.long()
    if data.dim() > 1:
        index = index.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(
            data)
    return out.scatter_reduce_(0, index, data, reduce=reduce,
                               include_self=True)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment minima; empty segments hold the dtype's max (+inf
    for floats)."""
    identity = (float("inf") if data.dtype.is_floating_point
                else torch.iinfo(data.dtype).max)
    return _segment_reduce(data, segment_ids, num_segments, "amin",
                           identity)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maxima; empty segments hold the dtype's min (-inf
    for floats)."""
    identity = (float("-inf") if data.dtype.is_floating_point
                else torch.iinfo(data.dtype).min)
    return _segment_reduce(data, segment_ids, num_segments, "amax",
                           identity)


def resource_sum(x: torch.Tensor, fr_resource: torch.Tensor,
                 n_resources: int) -> torch.Tensor:
    """``x @ onehot(fr_resource)`` for integer ``x`` [..., F]: the sum of
    each resource's FR columns, [..., R], wrapping in int32 like XLA's
    int32 dot (an integer ``index_add`` is exact in any order)."""
    out = torch.zeros(tuple(x.shape[:-1]) + (n_resources,), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(x.dim() - 1, fr_resource.long(), x)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: indices sorting by the LAST key first, ties
    broken by the earlier keys, stable; int32."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order.to(INT32)


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """Integer division rounding toward -inf (JAX's ``//``)."""
    return torch.div(a, b, rounding_mode="floor")


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0, accumulated in int32."""
    return torch.cumsum(x, dim=0, dtype=INT32)


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum along axis 0
    (``lax.associative_scan(jnp.maximum, x)``)."""
    return torch.cummax(x, dim=0).values


def sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Sum of all elements as an int32 0-d tensor (wraps like JAX)."""
    return x.sum(dtype=torch.int64).to(INT32)


def arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=INT32, device=device)
