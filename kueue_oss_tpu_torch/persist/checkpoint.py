"""Atomic store checkpoints (docs/DURABILITY.md).

A copy of ``kueue_oss_tpu/persist/checkpoint.py``; the atomic write
goes through the port's ``util/fsutil.py``.

A checkpoint file is one header line of JSON metadata (id, payload
sha256, payload size) followed by the canonical store dump. The write
is crash-atomic: same-directory temp file, flush + fsync, ``os.replace``
onto the final name, then a **directory fsync** so the rename itself
survives power loss (the same fix applied to ``obs.dump_jsonl`` — an
fsynced file behind an un-fsynced rename is not durable).

Loading validates the sha256 over the payload; a torn or corrupt
checkpoint (a crash between temp-write and replace leaves only the
temp file, which is never considered) is skipped and the next-newest
one is used — recovery never trusts an unverified snapshot.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Optional

from kueue_oss_tpu_torch.persist import hooks
from kueue_oss_tpu_torch.util.fsutil import fsync_dir

__all__ = ["CorruptCheckpoint", "chain_ids", "checkpoint_path",
           "fsync_dir", "is_incremental", "list_checkpoints",
           "load_checkpoint", "load_checkpoint_meta", "newest_valid",
           "newest_valid_chain", "write_checkpoint"]

_NAME = re.compile(r"^checkpoint-(\d+)\.ckpt$")


class CorruptCheckpoint(ValueError):
    pass


def checkpoint_path(dir_path: str, ckpt_id: int) -> str:
    return os.path.join(dir_path, f"checkpoint-{ckpt_id:08d}.ckpt")


def write_checkpoint(dir_path: str, ckpt_id: int, state: bytes,
                     extra_meta: Optional[dict] = None) -> str:
    meta = {
        "version": 1,
        "id": int(ckpt_id),
        "sha256": hashlib.sha256(state).hexdigest(),
        "size": len(state),
    }
    if extra_meta:
        meta.update(extra_meta)
    path = checkpoint_path(dir_path, ckpt_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(json.dumps(meta, sort_keys=True,
                               separators=(",", ":")).encode())
            f.write(b"\n")
            f.write(state)
            f.flush()
            os.fsync(f.fileno())
        hooks.crash_if("mid_checkpoint")
        os.replace(tmp, path)
        fsync_dir(dir_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint_meta(path: str) -> dict:
    """Header-only read: the metadata line without the payload.

    The chain-closure prune path runs on EVERY checkpoint — at the
    sub-second cadences incremental checkpoints enable, re-reading and
    re-hashing each retained chain's multi-MB full base would dwarf
    the delta write the cadence just saved; link resolution only
    needs ``kind``/``base``. Payload integrity is still verified
    wherever the payload is actually used (load_checkpoint)."""
    with open(path, "rb") as f:
        header = f.readline()
    try:
        meta = json.loads(header)
    except ValueError as e:
        raise CorruptCheckpoint(f"{path}: bad header: {e}") from e
    if not isinstance(meta, dict) or "sha256" not in meta:
        raise CorruptCheckpoint(f"{path}: header is not checkpoint meta")
    return meta


def load_checkpoint(path: str) -> tuple[dict, bytes]:
    """Returns (meta, state bytes); raises CorruptCheckpoint when the
    header is unparseable or the payload fails its hash."""
    with open(path, "rb") as f:
        header = f.readline()
        state = f.read()
    try:
        meta = json.loads(header)
    except ValueError as e:
        raise CorruptCheckpoint(f"{path}: bad header: {e}") from e
    if not isinstance(meta, dict) or "sha256" not in meta:
        raise CorruptCheckpoint(f"{path}: header is not checkpoint meta")
    if len(state) != meta.get("size"):
        raise CorruptCheckpoint(
            f"{path}: payload {len(state)}B != declared {meta.get('size')}B")
    if hashlib.sha256(state).hexdigest() != meta["sha256"]:
        raise CorruptCheckpoint(f"{path}: payload hash mismatch")
    return meta, state


def list_checkpoints(dir_path: str) -> list[tuple[int, str]]:
    """(id, path) of every checkpoint file, newest first."""
    out = []
    try:
        names = os.listdir(dir_path)
    except FileNotFoundError:
        return out
    for name in names:
        m = _NAME.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_path, name)))
    out.sort(reverse=True)
    return out


def newest_valid(dir_path: str) -> Optional[tuple[dict, bytes]]:
    """The newest checkpoint that passes validation, or None."""
    for _ckpt_id, path in list_checkpoints(dir_path):
        try:
            return load_checkpoint(path)
        except (CorruptCheckpoint, OSError):
            continue
    return None


def is_incremental(meta: dict) -> bool:
    return meta.get("kind") == "incremental"


def newest_valid_chain(dir_path: str
                       ) -> Optional[list[tuple[dict, bytes]]]:
    """The newest checkpoint whose whole delta chain validates,
    resolved full-base-first: ``[full, incr, ..., newest]``.

    Incremental checkpoints (docs/DURABILITY.md "Incremental
    checkpoints") carry ``meta["kind"] == "incremental"`` and a
    ``meta["base"]`` pointer at the checkpoint they delta against.
    A candidate with a corrupt or missing link anywhere in its chain
    is skipped entirely and the next-newest candidate is tried —
    recovery never materializes a partial chain.
    """
    by_id = dict(list_checkpoints(dir_path))
    for ckpt_id in sorted(by_id, reverse=True):
        chain: list[tuple[dict, bytes]] = []
        cur: Optional[int] = ckpt_id
        ok = True
        seen: set[int] = set()
        while cur is not None:
            path = by_id.get(cur)
            if path is None or cur in seen:
                ok = False
                break
            seen.add(cur)
            try:
                meta, state = load_checkpoint(path)
            except (CorruptCheckpoint, OSError):
                ok = False
                break
            chain.append((meta, state))
            cur = (int(meta["base"]) if is_incremental(meta)
                   else None)
        if ok and chain:
            chain.reverse()
            return chain
    return None


def chain_ids(dir_path: str, ckpt_id: int) -> set[int]:
    """Checkpoint ids in ``ckpt_id``'s delta chain (itself included),
    or just {ckpt_id} when the chain cannot be resolved — the prune
    path's retention closure (a full base outlives the window while
    a retained incremental still points at it)."""
    by_id = dict(list_checkpoints(dir_path))
    out: set[int] = set()
    cur: Optional[int] = ckpt_id
    while cur is not None and cur not in out and cur in by_id:
        out.add(cur)
        try:
            meta = load_checkpoint_meta(by_id[cur])
        except (CorruptCheckpoint, OSError):
            break
        cur = int(meta["base"]) if is_incremental(meta) else None
    return out or {ckpt_id}
