"""Filesystem durability primitives shared across subsystems.

An fsynced file behind an un-fsynced rename is not durable: the data
blocks survive power loss but the directory entry pointing at them may
not. Every atomic-write site (the persist/ checkpoint writer, the obs
journal dump) pairs ``os.replace`` with a directory fsync through this
helper (docs/DURABILITY.md).
"""

from __future__ import annotations

import os


def fsync_dir(dir_path: str) -> None:
    """Make directory-entry changes (os.replace, create, unlink)
    durable. No-op on platforms whose directories reject O_RDONLY
    opens (never the POSIX targets this runs on)."""
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
