"""Canonical serialization of API objects and whole stores.

A copy of ``kueue_oss_tpu/persist/codec.py``. Every durability surface
(WAL event records, checkpoints, the crash harness's byte-identity
assertions) needs one encoding with two properties:

- **round-trip fidelity**: decode(encode(obj)) reconstructs the object
  exactly, resource versions, uids, condition times and nested
  assignment state included;
- **byte stability**: encoding the same logical state twice yields the
  same bytes (sorted keys, compact separators, no NaN), so "recovered
  == no-crash" is a byte comparison.

The bytes are the JAX package's: a durability directory written by one
package recovers in the other. The port's API types leave out fields
that the JAX types carry (``CUT_FIELDS``, each with its JAX default in
``to_dict`` form) and the ``WorkloadPriorityClass`` kind. ``to_dict``
writes every cut field at its default and ``store_to_dict`` an empty
``WorkloadPriorityClass`` map, so a port store dumps to the JAX bytes.
Decoding a record whose cut field is not at its default, or a priority
class, raises ``CutFieldError`` naming it: dropping it would lose
durable state without a word.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import types as _pytypes
import typing

from kueue_oss_tpu_torch.api import types as api
from kueue_oss_tpu_torch.core.store import Store

#: the JAX types' fields the port's types leave out: class name ->
#: field -> its JAX default as ``dataclasses.asdict`` writes it
CUT_FIELDS = {
    "Workload": {"priority_class": None, "labels": {},
                 "max_execution_time": None, "replacement_for": None,
                 "parent_workload": None, "preemption_gates": []},
    "ClusterQueue": {"labels": {}},
    "LocalQueue": {"fair_sharing": {"weight": 1.0}},
    "PodSet": {"env": []},
    "AdmissionCheckState": {"pod_set_updates": [], "retry_count": 0},
}

#: the JAX kinds the port's store does not hold (always written empty)
CUT_KINDS = ("WorkloadPriorityClass",)


class CutFieldError(ValueError):
    """A durable record carries JAX-only state the port cannot hold."""


#: kind name -> (Store attribute, dataclass, key function)
KINDS = {
    "ClusterQueue": ("cluster_queues", api.ClusterQueue,
                     lambda o: o.name),
    "Cohort": ("cohorts", api.Cohort, lambda o: o.name),
    "LocalQueue": ("local_queues", api.LocalQueue, lambda o: o.key),
    "ResourceFlavor": ("resource_flavors", api.ResourceFlavor,
                       lambda o: o.name),
    "Topology": ("topologies", api.Topology, lambda o: o.name),
    "AdmissionCheck": ("admission_checks", api.AdmissionCheck,
                       lambda o: o.name),
    "Node": ("nodes", api.Node, lambda o: o.name),
    "Workload": ("workloads", api.Workload, lambda o: o.key),
}


def kind_of(obj) -> str | None:
    """The KINDS name for an API object instance, or None."""
    for kind, (_, cls, _key) in KINDS.items():
        if type(obj) is cls:
            return kind
    return None


def to_dict(obj) -> dict:
    """``dataclasses.asdict`` with every cut field at its JAX default."""
    return _asdict(obj)


def _asdict(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {f.name: _asdict(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        cut = CUT_FIELDS.get(type(obj).__name__)
        if cut:
            out.update(copy.deepcopy(cut))
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_asdict(v) for v in obj)
    if isinstance(obj, dict):
        return type(obj)((_asdict(k), _asdict(v)) for k, v in obj.items())
    return copy.deepcopy(obj)


# -- generic typed decode ----------------------------------------------------

_HINTS: dict[type, dict] = {}


def _hints(cls) -> dict:
    if cls not in _HINTS:
        # resolves the `from __future__ import annotations` strings
        _HINTS[cls] = typing.get_type_hints(cls)
    return _HINTS[cls]


def _decode(tp, v):
    if v is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is _pytypes.UnionType:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _decode(args[0], v) if args else v
    if origin is list:
        args = typing.get_args(tp)
        et = args[0] if args else typing.Any
        return [_decode(et, x) for x in v]
    if origin is tuple:
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode(args[0], x) for x in v)
        if args:
            return tuple(_decode(t, x) for t, x in zip(args, v))
        return tuple(v)
    if origin is dict:
        args = typing.get_args(tp)
        vt = args[1] if len(args) == 2 else typing.Any
        return {k: _decode(vt, x) for k, x in v.items()}
    if dataclasses.is_dataclass(tp) and isinstance(tp, type):
        for name, default in CUT_FIELDS.get(tp.__name__, {}).items():
            if name in v and v[name] != default:
                raise CutFieldError(
                    f"{tp.__name__}.{name} = {v[name]!r}: the port's "
                    f"{tp.__name__} has no {name} field (only its "
                    f"default {default!r} decodes)")
        hints = _hints(tp)
        kwargs = {
            f.name: _decode(hints[f.name], v[f.name])
            for f in dataclasses.fields(tp)
            if f.init and f.name in v
        }
        return tp(**kwargs)
    return v


def from_dict(kind: str, data: dict):
    """Decode one API object of `kind` from its to_dict() form."""
    if kind in CUT_KINDS:
        raise CutFieldError(f"a {kind} record: the port's store holds "
                            f"no {kind} objects")
    _, cls, _key = KINDS[kind]
    return _decode(cls, data)


# -- whole-store form --------------------------------------------------------


def store_to_dict(store: Store) -> dict:
    """The store's full durable state as one plain dict."""
    with store._lock:
        out: dict = {
            "version": 1,
            "namespaces": {ns: dict(labels)
                           for ns, labels in store.namespaces.items()},
            "cq_generation": dict(store.cq_generation),
        }
        for kind, (attr, _cls, _key) in KINDS.items():
            out[kind] = {key: to_dict(obj)
                         for key, obj in getattr(store, attr).items()}
        for kind in CUT_KINDS:
            out[kind] = {}
        return out


def canonical_json(data) -> bytes:
    return json.dumps(data, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode()


def canonical_dump(store: Store) -> bytes:
    """Byte-stable dump of the store — the crash harness's equality
    currency ("recovered == no-crash" is a byte comparison)."""
    return canonical_json(store_to_dict(store))


def store_from_dict(data: dict, store: Store | None = None) -> Store:
    """Rebuild a Store from store_to_dict() output.

    Objects land verbatim (no resource_version bumps — they already
    carry their post-write state, and no store write runs), the
    admitted/finished indexes are rebuilt from the restored workloads,
    and the process-wide uid counter is advanced past every restored
    uid so new workloads cannot collide with recovered ones.
    """
    for kind in CUT_KINDS:
        if data.get(kind):
            raise CutFieldError(
                f"{kind} objects {sorted(data[kind])}: the port's store "
                f"holds no {kind} objects")
    out = store if store is not None else Store()
    with out._lock:
        out.namespaces = {ns: dict(labels)
                          for ns, labels in data.get("namespaces", {}).items()}
        out.cq_generation = {k: int(v)
                             for k, v in data.get("cq_generation", {}).items()}
        for kind, (attr, _cls, _key) in KINDS.items():
            target = getattr(out, attr)
            target.clear()
            for key, od in data.get(kind, {}).items():
                target[key] = from_dict(kind, od)
        rebuild_indexes(out)
    advance_uid_floor(max((wl.uid for wl in out.workloads.values()),
                          default=0))
    return out


def rebuild_indexes(store: Store) -> None:
    """Recompute the admitted index, the cached-info side table and the
    finished-transition set from the workloads dict alone (recovery and
    the auditor's auto-heal share this)."""
    store._admitted.clear()
    store._admitted_infos.clear()
    store._finished_counted = {
        k for k, wl in store.workloads.items() if wl.is_finished}
    for wl in store.workloads.values():
        if wl.is_quota_reserved and not wl.is_finished:
            store._admitted[wl.key] = wl


def advance_uid_floor(floor: int) -> None:
    """Ensure freshly created Workloads get uids strictly above `floor`
    (recovery must not let the process-wide counter re-issue restored
    uids — queue ordering ties break on uid)."""
    if floor <= 0:
        return
    probe = next(api._uid_counter)
    nxt = max(probe, floor + 1)
    api._uid_counter = itertools.count(nxt)
