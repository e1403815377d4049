"""Carry solver state into the port from arrays named by field.

The functions take plain numpy arrays (or duck-typed objects exposing
them as attributes), so a problem exported elsewhere — the JAX
package's ``SolverProblem``, ``TASLevels`` or the FULL drain's host
tensors (``host_tensors_full``), or arrays loaded from a
file — can be solved by the port without the port importing it. Dtypes
are checked, never coerced: a wrong dtype is a caller bug.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kueue_oss_tpu_torch.solver.full_kernels import (
    FullTensors,
    field_dtype,
    tensors_to_device,
)
from kueue_oss_tpu_torch.solver.tas_kernels import TASLevels
from kueue_oss_tpu_torch.solver.tensors import ARRAY_FIELDS, SolverProblem

#: boolean fields of SolverProblem; every other array field is int32
_BOOL_FIELDS = frozenset({"has_parent", "has_borrow", "cq_strict",
                          "cq_try_next", "wl_valid"})


def _get(obj, name):
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _has(obj, name) -> bool:
    return name in obj if isinstance(obj, dict) else hasattr(obj, name)


def _array(name: str, value, dtype) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype != dtype:
        raise TypeError(f"{name}: expected {np.dtype(dtype)}, got "
                        f"{arr.dtype}")
    return arr


def problem_from_arrays(obj) -> SolverProblem:
    """A port ``SolverProblem`` from an object or mapping carrying the
    lean drain's arrays by field name (int32, or bool where the field is
    a mask). Decode tables are copied when present."""
    kwargs = {
        name: _array(name, _get(obj, name),
                     np.bool_ if name in _BOOL_FIELDS else np.int32)
        for name in ARRAY_FIELDS}
    for f in dataclasses.fields(SolverProblem):
        if f.name not in kwargs and _has(obj, f.name):
            kwargs[f.name] = _get(obj, f.name)
    return SolverProblem(**kwargs)


def levels_from_arrays(parents, leaf_capacity, leaf_names,
                       resources) -> TASLevels:
    """A port ``TASLevels`` from per-level int32 parent arrays and the
    [D_leaf, R] int32 leaf capacity matrix."""
    return TASLevels(
        parents=[_array(f"parents[{i}]", p, np.int32)
                 for i, p in enumerate(parents)],
        leaf_capacity=_array("leaf_capacity", leaf_capacity, np.int32),
        leaf_names=[tuple(n) for n in leaf_names],
        resources=list(resources),
    )


def full_tensors_from_arrays(obj, device) -> FullTensors:
    """The port's ``FullTensors`` on ``device`` from an object or mapping
    carrying every FULL-drain input array by field name, each in the
    dtype the port uses (int32, bool or float32; the two bases are 0-d
    int32)."""
    return tensors_to_device(FullTensors(**{
        name: _array(name, _get(obj, name), field_dtype(name))
        for name in FullTensors._fields}), device)
